"""A serving step's rows, each computed on the card in an order that its
batch does not change.

On the card, PyTorch's reductions and cuBLAS choose how to split a row's
sum from the shape of the whole tensor, so the same decode row can round
differently at B 1 and at B 4: phi3-mini's RMSNorm moved 13 of 3072
bf16 outputs, and phi3.5-moe's router, dense combine and per-tensor
GEMMs moved its logits by up to 0.245.  A request served beside others,
or preempted into a smaller batch, then leaves the stream it gives
alone.

The engine runs its decode and verify steps under ``rows(n)``, ``n``
being the most rows one of its steps can take (``num_slots`` decode
rows, ``num_slots·spec_k`` with speculative verify).  There a CUDA
tensor of at most ``n`` rows takes the helpers' fixed order: ``mean``,
``sum_last`` and ``expert_sum`` halve each row with elementwise adds,
``matmul`` multiplies each row alone.  Everywhere else (training,
larger prefill chunks, and the CPU, whose order follows XLA's
elsewhere) they are the plain torch calls.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from .formats import div_c

_ROWS = contextvars.ContextVar("repro_torch_row_order", default=0)


@contextlib.contextmanager
def rows(n: int):
    """Within: a CUDA tensor of at most ``n`` rows takes the fixed
    order."""
    token = _ROWS.set(int(n))
    try:
        yield
    finally:
        _ROWS.reset(token)


def fixed(x: torch.Tensor, n_rows: int) -> bool:
    """Whether ``x``, which belongs to ``n_rows`` rows of the step, takes
    the fixed order."""
    return x.device.type == "cuda" and n_rows <= _ROWS.get()


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in one order for every row (the fixed order
    of a tensor found ``fixed``): halve the row with elementwise adds
    while its length is even, then add what is left from the left."""
    k = x.shape[-1]
    while k % 2 == 0 and k > 1:
        k //= 2
        x = x[..., :k] + x[..., k:]
    total = x[..., 0]
    for i in range(1, k):
        total = total + x[..., i]
    return total


def mean(x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """Mean over the last dim, keepdim (the norms' f32 mean off the
    CPU); ``x`` belongs to ``rows`` rows of the step (default: one a
    vector of the last dim; rwkv's group norm takes a token's heads as
    one row)."""
    d = x.shape[-1]
    if fixed(x, x.numel() // d if rows is None else rows):
        return div_c(sum_last(x), float(d))[..., None]
    return x.mean(dim=-1, keepdim=True)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N)."""
    k = x.shape[-1]
    m = x.numel() // k
    if m > 1 and fixed(x, m):
        flat = x.reshape(m, k)
        out = torch.cat([flat[i:i + 1] @ w for i in range(m)])
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x @ w


def expert_sum(ys: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(T, d) = sum over e of ``weights[t, e] · ys[e, t, :]``, in f32."""
    ys = ys.to(torch.float32)
    if fixed(ys, ys.shape[1]):
        return sum_last((ys * weights.T[:, :, None]).movedim(0, -1))
    return torch.einsum("etd,te->td", ys, weights)
