"""Paged decode attention: the wrapper of the Hopper kernel
``csrc/decode_attn.cu`` and its plain PyTorch version.

One query position per slot (q_len = 1) against the floating page
pool: q (B, KV, R, Dh) with R the padded group rows, k/v pools
(P, KV, T, Dh) in e4m3 (with (P, KV, T) f32 scales) or bf16 (scales
None), n_valid (B,) int32 logical depths and block_table (B, NP) int32.
Logical slot t of row b lives in physical page ``block_table[b, t // T]``
at offset ``t % T`` and is live iff ``t < min(n_valid[b], NP·T)``;
every entry of n_valid must be >= 1.  Returns (B, KV, R, Dh) f32.
Replaces the TPU kernel ``repro.kernels.decode_attn.
decode_attn_paged_pallas``; the plain version follows
``repro.kernels.ref.decode_attn_paged_ref``.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.runtime_flags import einsum

from ._build import LaunchCounter, check, library

NEG_INF = -1e30
MAX_DH = 128

counter = LaunchCounter("decode_attn_paged")


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, KV, T, ...) pool + (B, NP) table -> (B, KV, NP·T, ...)."""
    b, n_p = block_table.shape
    raw = pool.view(torch.uint8) if pool.element_size() == 1 else pool
    g = raw[block_table.long()].view(pool.dtype)   # (B, NP, KV, T, ...)
    g = g.movedim(2, 1)                        # (B, KV, NP, T, ...)
    return g.reshape(b, g.shape[1], n_p * pool.shape[2], *pool.shape[3:])


def decode_attn_ref(q, k, v, k_scale, v_scale, n_valid, *,
                    sm_scale: float) -> torch.Tensor:
    """Contiguous-cache decode attention: q (B, KV, G, Dh), k/v
    (B, KV, C, Dh), scales (B, KV, C) or None, n_valid (B,).  Scales
    fold into the score (K) and the combine weight (V); slots
    ``>= min(n_valid[b], C)`` are masked."""
    c = k.shape[2]
    scores = einsum("bkgd,bktd->bkgt", q, k) * sm_scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    lim = torch.clamp_max(n_valid.to(torch.int64), c)
    valid = torch.arange(c, device=q.device)[None, :] < lim[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        w = w * v_scale[:, :, None, :]
    return einsum("bkgt,bktd->bkgd", w, v)


def decode_attn_paged_plain(q, k, v, k_scale, v_scale, n_valid,
                            block_table, *, sm_scale: float
                            ) -> torch.Tensor:
    """Gather each slot's pages into the contiguous layout, then the
    contiguous version (as ``repro.kernels.ref.decode_attn_paged_ref``)."""
    kg, vg = gather_pages(k, block_table), gather_pages(v, block_table)
    ksg = None if k_scale is None else gather_pages(k_scale, block_table)
    vsg = None if v_scale is None else gather_pages(v_scale, block_table)
    return decode_attn_ref(q, kg, vg, ksg, vsg, n_valid,
                           sm_scale=sm_scale)


def _check(q, k, v, k_scale, v_scale, n_valid, block_table):
    b, kvh, _, dh = q.shape
    p_pool, _, t, _ = k.shape
    if k.shape != v.shape or k.shape[1] != kvh or k.shape[3] != dh:
        raise ValueError(f"decode_attn_paged: q {tuple(q.shape)}, pool "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attn_paged: both scales or neither")
    if k_scale is not None:
        if k.dtype != torch.float8_e4m3fn:
            raise TypeError(f"decode_attn_paged: scaled pool {k.dtype}")
        if k_scale.shape != (p_pool, kvh, t) or v_scale.shape != \
                k_scale.shape:
            raise ValueError("decode_attn_paged: scale shapes "
                             f"{tuple(k_scale.shape)}")
    elif k.dtype != torch.bfloat16:
        raise TypeError(f"decode_attn_paged: unscaled pool {k.dtype}")
    if n_valid.shape != (b,) or block_table.dim() != 2 or \
            block_table.shape[0] != b:
        raise ValueError(f"decode_attn_paged: n_valid "
                         f"{tuple(n_valid.shape)}, block_table "
                         f"{tuple(block_table.shape)}")


def decode_attn_paged(q, k, v, k_scale, v_scale, n_valid, block_table, *,
                      sm_scale: float) -> torch.Tensor:
    """(B, KV, R, Dh) f32 attention output (see module docstring)."""
    _check(q, k, v, k_scale, v_scale, n_valid, block_table)
    if q.device.type == "cpu":
        return decode_attn_paged_plain(q, k, v, k_scale, v_scale, n_valid,
                                       block_table, sm_scale=sm_scale)
    dev = q.device
    tensors = [k, v, n_valid, block_table] + \
        ([k_scale, v_scale] if k_scale is not None else [])
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("decode_attn_paged: every operand must be on "
                         f"{dev}")
    b, kvh, rows, dh = q.shape
    if dh > MAX_DH:
        raise ValueError(f"decode_attn_paged: Dh={dh} > {MAX_DH}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("decode_attn_paged: operands must be contiguous")
    if n_valid.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise TypeError("decode_attn_paged: n_valid and block_table must "
                        "be int32")
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, rows, dh), dtype=torch.float32, device=dev)
    fp8 = k_scale is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = library().decode_attn_paged_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if fp8 else None,
            v_scale.data_ptr() if fp8 else None,
            n_valid.data_ptr(), block_table.data_ptr(), out.data_ptr(),
            b, kvh, rows, dh, k.shape[2], block_table.shape[1],
            float(sm_scale), int(fp8), stream)
    check(code, "decode_attn_paged")
    counter.hit()
    return out
