"""Decode attention: the wrappers of the Hopper kernel
``csrc/decode_attn.cu`` and their plain PyTorch versions.

q (B, KV, R, Dh) holds R = q_len · G query rows of each kv head,
draft-major: q_len = 1 is decode (one query position per slot), q_len
= k the speculative verify step, whose row r belongs to draft j = r // G
and sees the slots below ``min(n_valid[b] - (q_len-1-j), C)`` (n_valid
is the depth after the step's write, so draft j sees its own position
and the earlier drafts', not the later ones').  They run against

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

n_valid is (B,) int32 with every entry >= q_len; with q_len > 1 the
cache must be unwrapped, every entry <= C (both wrappers check, on
either device).  Dh is at most 256.  Returns (B, KV, R, Dh) f32.  One
kernel serves both layouts (only the slot address differs), so the same
bytes give the same bits through either, and through caches of another
capacity; draft j's rows are bitwise a q_len = 1 launch at that draft's
limit.  The kernel is one launch of a cluster of ``CLUSTER`` CTAs per
(b, kv head) that split the slots in chunks of ``CHUNK``; past
``SCORES_SMEM_MAX`` bytes of scores a CTA it takes a scratch buffer
(``_scratch``).  The plain versions take the
reference's 5-D form, q (B, KV, S, G, Dh) with S = q_len.

A CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.runtime_flags import einsum

from ._build import LaunchCounter, check, library

NEG_INF = -1e30
MAX_DH = 256
# the kernel's split (csrc/decode_attn.cu, namespace da): CTAs per
# cluster, slots per chunk, and the bytes of scores a CTA keeps in shared
# memory; past them its scores go to a scratch buffer passed here
CLUSTER, CHUNK, SCORES_SMEM_MAX = 8, 32, 96 * 1024

counter = LaunchCounter("decode_attn_paged")
counter_contiguous = LaunchCounter("decode_attn")
# the q_len > 1 (verify) launches of the same two kernels
counter_verify = LaunchCounter("decode_attn_paged_verify")
counter_contiguous_verify = LaunchCounter("decode_attn_verify")


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
    ``>= min(n_valid[b], C)`` are masked.

    A 5-D q (B, KV, S, G, Dh) is the verify form: draft j sees the
    slots below ``min(n_valid[b] - (S-1-j), C)``; returns
    (B, KV, S, G, Dh).  Both forms take the reference's 5-D einsum
    order, a 4-D q as one draft."""
    c = k.shape[2]
    q5 = q if q.dim() == 5 else q[:, :, None]
    scores = einsum("bksgd,bktd->bksgt", q5, k) * sm_scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, None, :]
    back = torch.arange(q5.shape[2] - 1, -1, -1, device=q.device)
    lim = torch.clamp_max(n_valid.to(torch.int64)[:, None] - back[None], c)
    valid = torch.arange(c, device=q.device)[None, None] < lim[:, :, None]
    scores = torch.where(valid[:, None, :, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        w = w * v_scale[:, :, None, None, :]
    out = einsum("bksgt,bktd->bksgd", w, v)
    return out if q.dim() == 5 else out[:, :, 0]


def decode_attn_paged_plain(q, k, v, k_scale, v_scale, n_valid,
                            block_table, *, sm_scale: float
                            ) -> torch.Tensor:
    """Gather each slot's pages into the contiguous layout, then the
    contiguous version (as ``repro.kernels.ref.decode_attn_paged_ref``);
    q 4-D or the 5-D verify form."""
    kg, vg = gather_pages(k, block_table), gather_pages(v, block_table)
    ksg = None if k_scale is None else gather_pages(k_scale, block_table)
    vsg = None if v_scale is None else gather_pages(v_scale, block_table)
    return decode_attn_ref(q, kg, vg, ksg, vsg, n_valid,
                           sm_scale=sm_scale)


def _check(name, q, k, v, k_scale, v_scale, n_valid, slots_shape, q_len,
           cap):
    """Shapes and types both layouts share; ``slots_shape`` is the
    scales' shape, (P, KV, T) or (B, KV, C), and ``cap`` the slots a
    row addresses (C or NP·T).  With q_len > 1, every n_valid entry
    must lie in [q_len, cap]: checked here on the CPU, and on the card
    by an assert on the device that does not wait for it."""
    b, kvh, rows, dh = q.shape
    if q_len < 1 or rows % q_len:
        raise ValueError(f"{name}: {rows} query rows, q_len {q_len}")
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
    if q_len > 1:
        ok = ((n_valid >= q_len) & (n_valid <= cap)).all()
        if n_valid.device.type == "cpu":
            if not bool(ok):
                raise ValueError(f"{name}: q_len {q_len} needs every "
                                 f"n_valid in [{q_len}, {cap}] (an "
                                 f"unwrapped cache), got "
                                 f"{n_valid.tolist()}")
        else:
            torch._assert_async(ok)


def plain_rows(fn, q, q_len, *args, sm_scale):
    """The plain version ``fn`` on the 4-D rows: q_len > 1 runs the 5-D
    form on (B, KV, q_len, R/q_len, Dh) and flattens the result back."""
    if q_len == 1:
        return fn(q, *args, sm_scale=sm_scale)
    b, kvh, rows, dh = q.shape
    out = fn(q.reshape(b, kvh, q_len, rows // q_len, dh), *args,
             sm_scale=sm_scale)
    return out.reshape(b, kvh, rows, dh)


def _scratch(q, rows, cap):
    """The scores' scratch buffer of a launch whose CTAs cannot keep
    their rows' scores in shared memory (a capacity past 10,752 slots
    at 16 rows), else None: per CTA, R + 2 rows (the scores, each
    slot's row index and V scale) of its local slots, f32."""
    chunks = -(-cap // CHUNK)
    local = -(-chunks // CLUSTER) * CHUNK
    if (rows + 2) * local * 4 <= SCORES_SMEM_MAX:
        return None
    b, kvh = q.shape[:2]
    return torch.empty(b * kvh * CLUSTER * (rows + 2) * local,
                       dtype=torch.float32, device=q.device)


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
                sm_scale: float, q_len: int = 1) -> torch.Tensor:
    """(B, KV, R, Dh) f32 attention output over a contiguous cache, R =
    q_len · G rows (see module docstring)."""
    b, kvh, rows, dh = q.shape
    _check("decode_attn", q, k, v, k_scale, v_scale, n_valid,
           (b, kvh, k.shape[2]), q_len, k.shape[2])
    if k.shape[0] != b:
        raise ValueError(f"decode_attn: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}")
    if q.device.type == "cpu":
        return plain_rows(decode_attn_ref, q, q_len, k, v, k_scale,
                          v_scale, n_valid, sm_scale=sm_scale)
    return launch(q, k, v, k_scale, v_scale, n_valid, sm_scale=sm_scale,
                  q_len=q_len)


def launch(q, k, v, k_scale, v_scale, n_valid, *, sm_scale: float,
           q_len: int = 1) -> torch.Tensor:
    """``decode_attn``'s launch on the card, without its shape and depth
    checks (``_check``): for operands that passed them."""
    b, kvh, rows, dh = q.shape
    fp8 = k_scale is not None
    tensors = [k, v, n_valid] + ([k_scale, v_scale] if fp8 else [])
    _launch_checks("decode_attn", q, tensors)
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, rows, dh), dtype=torch.float32,
                      device=q.device)
    scratch = _scratch(q, rows, k.shape[2])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = library().decode_attn_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if fp8 else None,
            v_scale.data_ptr() if fp8 else None,
            n_valid.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, kvh, rows,
            q_len, dh, k.shape[2], float(sm_scale), int(fp8), stream)
    check(code, "decode_attn")
    (counter_contiguous if q_len == 1 else counter_contiguous_verify).hit()
    return out


def decode_attn_paged(q, k, v, k_scale, v_scale, n_valid, block_table, *,
                      sm_scale: float, q_len: int = 1) -> torch.Tensor:
    """(B, KV, R, Dh) f32 attention output over the floating page pool,
    R = q_len · G rows (see module docstring)."""
    b, kvh, rows, dh = q.shape
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"decode_attn_paged: block_table "
                         f"{tuple(block_table.shape)}")
    _check("decode_attn_paged", q, k, v, k_scale, v_scale, n_valid,
           (k.shape[0], kvh, k.shape[2]), q_len,
           block_table.shape[1] * k.shape[2])
    if q.device.type == "cpu":
        return plain_rows(decode_attn_paged_plain, q, q_len, k, v,
                          k_scale, v_scale, n_valid, block_table,
                          sm_scale=sm_scale)
    return launch_paged(q, k, v, k_scale, v_scale, n_valid, block_table,
                        sm_scale=sm_scale, q_len=q_len)


def launch_paged(q, k, v, k_scale, v_scale, n_valid, block_table, *,
                 sm_scale: float, q_len: int = 1) -> torch.Tensor:
    """``decode_attn_paged``'s launch on the card, without its shape and
    depth checks (``_check``): for operands that passed them."""
    b, kvh, rows, dh = q.shape
    fp8 = k_scale is not None
    tensors = [k, v, n_valid, block_table] + \
        ([k_scale, v_scale] if fp8 else [])
    _launch_checks("decode_attn_paged", q, tensors)
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, rows, dh), dtype=torch.float32,
                      device=q.device)
    scratch = _scratch(q, rows, k.shape[2] * block_table.shape[1])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = library().decode_attn_paged_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if fp8 else None,
            v_scale.data_ptr() if fp8 else None,
            n_valid.data_ptr(), block_table.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, kvh, rows, q_len, dh, k.shape[2], block_table.shape[1],
            float(sm_scale), int(fp8), stream)
    check(code, "decode_attn_paged")
    (counter if q_len == 1 else counter_verify).hit()
    return out
