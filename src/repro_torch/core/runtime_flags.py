"""Matmul semantics and the serving flags this port honours.

Counterpart of ``repro.core.runtime_flags``.  Two things live here:

``mm`` / ``einsum``
    bf16-operand semantics with f32 accumulation: every operand is
    rounded to bf16 first, then multiplied with f32 accumulation.  The
    operands are handed over as f32 tensors holding bf16 values, which
    is what the reference does on the CPU (``mm_operand_dtype``).
    Products of bf16 values are exact in f32, so only the order of
    summation can differ from a bf16-operand matmul; on the card,
    ``torch.backends.cuda.matmul.allow_tf32`` must stay False (its
    default) for this to hold.  The quantized GEMMs do not come here:
    they go through ``repro_torch.kernels.dispatch``.

Serving and training flags
    The reference reads ``REPRO_*`` environment variables.  The port
    reads seven of them as the reference does: ``REPRO_SERVE_PAGED``
    (the paged engine, or the legacy ``Server`` under 0),
    ``REPRO_PAGED_PLACEMENT`` (float or identity pages),
    ``REPRO_CHUNKED_PREFILL`` (chunked, or the whole-prompt prefill
    under 0), ``REPRO_SPEC_DECODE`` (speculative verify steps under
    1), ``REPRO_SERVE_PREQUANT`` (weights quantized in every step
    against the build-time scales under 0), ``REPRO_SERVE_DELAYED_ACT``
    (just-in-time activation scales under 0) and ``REPRO_DECODE_ATTN``
    (``einsum``: the decode kernels' plain versions, on the card too).
    For the other two the port implements the reference's default
    (usage-based admission with preemption, no quant-health taps), and
    ``check_serving_env`` refuses one set to another value, naming the
    ROADMAP entry that will bring it.  The KV-cache dtype is the
    config's ``kv_cache_dtype`` alone: ``REPRO_KV_CACHE``, the
    reference's override of it, is refused whenever it is set, so that
    it cannot be silently ignored.  ``check_train_env`` does the same
    for the training CLI's one reference switch, ``REPRO_MOE_EXPERTS``.
"""

from __future__ import annotations

import os

import torch

# reference switch -> (value the port implements, ROADMAP entry that
# brings the others)
_SERVING_ENV = {
    "REPRO_PREEMPTION": ("1", "queue 1 item 8 (reservation admission "
                         "with preemption swap)"),
    "REPRO_QUANT_HEALTH": ("0", "queue 1 item 12 (observability)"),
}


def serve_prequant() -> bool:
    """Whether the serving path pre-quantizes weights at build time
    (else the bf16 tree is quantized in every step against the
    build-time scales: ``REPRO_SERVE_PREQUANT=0``)."""
    return os.environ.get("REPRO_SERVE_PREQUANT", "1").strip() != "0"


def serve_delayed_act() -> bool:
    """Whether serving consumes calibrated (delayed) activation scales
    instead of measuring each activation in the step
    (``REPRO_SERVE_DELAYED_ACT=0``: just in time)."""
    return os.environ.get("REPRO_SERVE_DELAYED_ACT", "1").strip() != "0"


# "kernel": the decode kernels (the default); "einsum": their plain
# scale-folding einsum versions, on either device (the A/B hatch)
DECODE_ATTN_PATHS = ("kernel", "einsum")


def decode_attn_path() -> str:
    """The decode-attention path: ``REPRO_DECODE_ATTN``, else the
    kernel."""
    env = os.environ.get("REPRO_DECODE_ATTN", "").strip()
    if env:
        if env not in DECODE_ATTN_PATHS:
            raise ValueError(f"REPRO_DECODE_ATTN={env!r}: expected one of "
                             f"{DECODE_ATTN_PATHS}")
        return env
    return "kernel"


def serve_paged() -> bool:
    """Whether the serving CLI drives the paged engine (the legacy
    ``Server`` under ``REPRO_SERVE_PAGED=0``)."""
    return os.environ.get("REPRO_SERVE_PAGED", "1").strip() != "0"


PAGED_PLACEMENTS = ("float", "identity")


def paged_placement() -> str:
    """The engine's page placement: ``REPRO_PAGED_PLACEMENT``, else
    floating pages (where the arch and max_len allow them)."""
    env = os.environ.get("REPRO_PAGED_PLACEMENT", "").strip()
    if env:
        if env not in PAGED_PLACEMENTS:
            raise ValueError(f"REPRO_PAGED_PLACEMENT={env!r}: expected one "
                             f"of {PAGED_PLACEMENTS}")
        return env
    return "float"


def chunked_prefill() -> bool:
    """Whether the engine prefills in chunks interleaved with decode
    steps (where the arch and max_len allow it), or whole prompts under
    ``REPRO_CHUNKED_PREFILL=0``."""
    return os.environ.get("REPRO_CHUNKED_PREFILL", "1").strip() != "0"


def spec_decode() -> bool:
    """Whether the serving engine runs speculative verify steps in the
    decode phase (``REPRO_SPEC_DECODE=1``; the chunked scheduler only).
    Off by default: greedy output is the same either way, and the gain
    depends on how often the drafts are accepted."""
    return os.environ.get("REPRO_SPEC_DECODE", "0").strip() == "1"


def check_serving_env() -> None:
    """Raise ``NotImplementedError`` when a reference serving switch is
    set to a value this port does not implement (an unset or default
    value is fine)."""
    if os.environ.get("REPRO_KV_CACHE", "").strip():
        raise NotImplementedError(
            "REPRO_KV_CACHE is not read by the port: set the config's "
            "kv_cache_dtype instead")
    for name, (value, entry) in _SERVING_ENV.items():
        got = os.environ.get(name, "").strip()
        if got and got != value:
            raise NotImplementedError(
                f"{name}={got!r} is not ported yet: ROADMAP {entry}")


def check_train_env() -> None:
    """Raise ``NotImplementedError`` when ``REPRO_MOE_EXPERTS`` asks for
    another MoE expert path than the one the port implements: moss and
    bf16 run the grouped kernels (``grouped``, the reference's default);
    the reference's ``vmapped`` A/B path for them is not ported."""
    got = os.environ.get("REPRO_MOE_EXPERTS", "").strip()
    if got and got != "grouped":
        raise NotImplementedError(
            f"REPRO_MOE_EXPERTS={got!r} is not ported: the port runs "
            "moss and bf16 experts grouped (ROADMAP queue 1 item 10)")


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor,
       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Matmul with bf16-operand semantics and f32 accumulation."""
    return torch.matmul(_bf16_values(a), _bf16_values(b)).to(out_dtype)


def einsum(spec: str, *args: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.einsum`` with bf16-operand semantics, f32 accumulation."""
    return torch.einsum(spec, *[_bf16_values(a) for a in args]
                        ).to(out_dtype)
