"""Decode attention: the wrappers of the Hopper kernel
``csrc/decode_attn.cu`` and their plain PyTorch versions.

One query position per slot (q_len = 1): q (B, KV, R, Dh) with R the
query rows of each kv head, against

- a contiguous (ring) cache (``decode_attn``): k/v (B, KV, C, Dh) in
  e4m3 (with (B, KV, C) f32 scales) or bf16 (scales None); slot t of row
  b is live iff ``t < min(n_valid[b], C)``, so a wrapped ring is fully
  live.  Replaces the TPU kernel ``repro.kernels.decode_attn.
  decode_attn_pallas``; the plain version is ``decode_attn_ref``
  (``repro.kernels.ref.decode_attn_ref``'s einsum order);
- the floating page pool (``decode_attn_paged``): k/v pools
  (P, KV, T, Dh) and block_table (B, NP) int32; logical slot t of row b
  lives in physical page ``block_table[b, t // T]`` at offset ``t % T``
  and is live iff ``t < min(n_valid[b], NP·T)``.  Replaces
  ``decode_attn_paged_pallas``; the plain version follows
  ``repro.kernels.ref.decode_attn_paged_ref``.

n_valid is (B,) int32 with every entry >= 1; Dh is at most 256.
Returns (B, KV, R, Dh) f32.  One kernel serves both layouts (only the
slot address differs), so the same bytes give the same bits through
either.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.runtime_flags import einsum

from ._build import LaunchCounter, check, library

NEG_INF = -1e30
MAX_DH = 256

counter = LaunchCounter("decode_attn_paged")
counter_contiguous = LaunchCounter("decode_attn")


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


def _check(name, q, k, v, k_scale, v_scale, n_valid, slots_shape):
    """Shapes and types both layouts share; ``slots_shape`` is the
    scales' shape, (P, KV, T) or (B, KV, C)."""
    b, kvh, _, dh = q.shape
    if k.shape != v.shape or k.shape[1] != kvh or k.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: both scales or neither")
    if k_scale is not None:
        if k.dtype != torch.float8_e4m3fn:
            raise TypeError(f"{name}: scaled cache {k.dtype}")
        if k_scale.shape != slots_shape or v_scale.shape != slots_shape:
            raise ValueError(f"{name}: scale shapes "
                             f"{tuple(k_scale.shape)}")
    elif k.dtype != torch.bfloat16:
        raise TypeError(f"{name}: unscaled cache {k.dtype}")
    if n_valid.shape != (b,):
        raise ValueError(f"{name}: n_valid {tuple(n_valid.shape)}")


def _launch_checks(name, q, tensors):
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: every operand must be on {dev}")
    if q.shape[-1] > MAX_DH:
        raise ValueError(f"{name}: Dh={q.shape[-1]} > {MAX_DH}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(x.dtype != torch.int32 for x in tensors if not
           x.is_floating_point()):
        raise TypeError(f"{name}: n_valid and block_table must be int32")


def decode_attn(q, k, v, k_scale, v_scale, n_valid, *,
                sm_scale: float) -> torch.Tensor:
    """(B, KV, R, Dh) f32 attention output over a contiguous cache (see
    module docstring)."""
    b, kvh, rows, dh = q.shape
    _check("decode_attn", q, k, v, k_scale, v_scale, n_valid,
           (b, kvh, k.shape[2]))
    if k.shape[0] != b:
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}")
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, k_scale, v_scale, n_valid,
                               sm_scale=sm_scale)
    fp8 = k_scale is not None
    tensors = [k, v, n_valid] + ([k_scale, v_scale] if fp8 else [])
    _launch_checks("decode_attn", q, tensors)
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, rows, dh), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = library().decode_attn_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if fp8 else None,
            v_scale.data_ptr() if fp8 else None,
            n_valid.data_ptr(), out.data_ptr(), b, kvh, rows, dh,
            k.shape[2], float(sm_scale), int(fp8), stream)
    check(code, "decode_attn")
    counter_contiguous.hit()
    return out


def decode_attn_paged(q, k, v, k_scale, v_scale, n_valid, block_table, *,
                      sm_scale: float) -> torch.Tensor:
    """(B, KV, R, Dh) f32 attention output over the floating page pool
    (see module docstring)."""
    b, kvh, rows, dh = q.shape
    _check("decode_attn_paged", q, k, v, k_scale, v_scale, n_valid,
           (k.shape[0], kvh, k.shape[2]))
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"decode_attn_paged: block_table "
                         f"{tuple(block_table.shape)}")
    if q.device.type == "cpu":
        return decode_attn_paged_plain(q, k, v, k_scale, v_scale, n_valid,
                                       block_table, sm_scale=sm_scale)
    fp8 = k_scale is not None
    tensors = [k, v, n_valid, block_table] + \
        ([k_scale, v_scale] if fp8 else [])
    _launch_checks("decode_attn_paged", q, tensors)
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, rows, dh), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
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
