"""Draft sources for speculative decoding (a copy of
``repro.serving.spec``: host-side numpy, no model and no device state).

Greedy verification commits a draft token iff it equals the model's own
argmax at that position, so any proposal stream gives token for token
the output of plain decode: a good draft source changes only how many
tokens each verify step commits, never which.

Draft source contract: anything with a ``propose(req, k) -> list[int]``
method.

  req   the scheduler ``Request``: ``req.prompt`` (np.int32 array) and
        ``req.out`` (the tokens committed so far, never empty in the
        decode phase) are the visible context
  k     the most draft tokens wanted (k >= 1)

It returns up to ``k`` proposed continuation tokens, possibly fewer or
none (the engine takes a plain decode step when no slot proposes
anything).  ``propose`` runs on the host between device steps.
"""

from __future__ import annotations

from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class DraftSource(Protocol):
    """Structural type of a draft source (see module docstring)."""

    def propose(self, req, k: int) -> Sequence[int]:
        ...


class NgramDraft:
    """Greedy n-gram (prompt-lookup) drafting: match the longest suffix
    of the committed context (``prompt + out``, from ``max_ngram`` down
    to ``min_ngram`` tokens) against an earlier occurrence in that same
    context, and propose the tokens that followed it.  Strong where a
    continuation repeats (code, structured text, quoting the prompt)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, req, k: int) -> list[int]:
        ctx = np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.out, np.int64)])
        t = len(ctx)
        for n in range(min(self.max_ngram, t - 1), self.min_ngram - 1,
                       -1):
            suffix = ctx[t - n:]
            # the most recent earlier occurrence wins (local repetition
            # beats a stale match far back in the prompt)
            for i in range(t - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], suffix):
                    cont = ctx[i + n:i + n + k]
                    if len(cont):
                        return [int(x) for x in cont]
                    break
        return []


class ModelDraft:
    """Hook for a small draft model: adapts a token-level callable
    ``propose_fn(context, k) -> Sequence[int]`` (``context`` the whole
    committed token list, prompt then output) to the draft-source
    contract.  Exactness does not depend on the draft model's quality or
    vocabulary: a mismatching token is rejected and the target model's
    own token is committed in its place."""

    def __init__(self, propose_fn: Callable[[list[int], int],
                                            Sequence[int]]):
        self.propose_fn = propose_fn

    def propose(self, req, k: int) -> list[int]:
        ctx = [int(x) for x in np.asarray(req.prompt)] + \
              [int(x) for x in req.out]
        return [int(x) for x in self.propose_fn(ctx, k)][:k]
