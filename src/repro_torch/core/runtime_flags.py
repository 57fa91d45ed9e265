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
    The reference reads ``REPRO_*`` environment variables, and the port
    reads them with the same names, defaults and errors:
    ``REPRO_SERVE_PAGED`` (the paged engine, or the legacy ``Server``
    under 0), ``REPRO_PAGED_PLACEMENT`` (float or identity pages),
    ``REPRO_CHUNKED_PREFILL`` (chunked, or the whole-prompt prefill
    under 0), ``REPRO_PREEMPTION`` (usage-based admission with
    preemption to host, or reservation admission under 0),
    ``REPRO_PREFIX_CACHE`` (prefix-hit page sharing, off under 0),
    ``REPRO_SPEC_DECODE`` (speculative verify steps under 1),
    ``REPRO_SERVE_PREQUANT`` (weights quantized in every step against
    the build-time scales under 0), ``REPRO_SERVE_DELAYED_ACT``
    (just-in-time activation scales under 0), ``REPRO_DECODE_ATTN``
    (``einsum``: the decode kernels' plain versions, on the card too),
    ``REPRO_KV_CACHE`` (``bf16`` or ``fp8``: every config's KV-cache
    dtype, ``models.attention.resolve_kv_cache_dtype``), the
    observability gates ``REPRO_QUANT_HEALTH`` /
    ``REPRO_QUANT_HEALTH_EVERY`` (``repro_torch.obs.quant_health``) and
    ``REPRO_TRACE`` (``repro_torch.obs.trace``), and the training CLI's
    ``REPRO_MOE_EXPERTS`` (``grouped`` or ``vmapped``; the CLI reads it
    before training starts).
"""

from __future__ import annotations

import os

import torch


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


def serve_preemption() -> bool:
    """Whether the paged engine admits against actual page usage and
    preempts running requests to host when the pool runs dry (floating
    pages and chunked prefill only); ``REPRO_PREEMPTION=0`` admits on
    worst-case reservations and never swaps."""
    return os.environ.get("REPRO_PREEMPTION", "1").strip() != "0"


def serve_prefix_cache() -> bool:
    """Whether the floating-page engine hashes page-aligned prompt
    prefixes and maps hits copy-on-write onto the shared physical pages
    (``REPRO_PREFIX_CACHE=0``: every request prefills cold)."""
    return os.environ.get("REPRO_PREFIX_CACHE", "1").strip() != "0"


def spec_decode() -> bool:
    """Whether the serving engine runs speculative verify steps in the
    decode phase (``REPRO_SPEC_DECODE=1``; the chunked scheduler only).
    Off by default: greedy output is the same either way, and the gain
    depends on how often the drafts are accepted."""
    return os.environ.get("REPRO_SPEC_DECODE", "0").strip() == "1"


# Observability (repro_torch.obs).  Both gates are off by default, and
# off is free: the serving steps are built without telemetry.
def quant_health() -> bool:
    """Whether serving steps also return per-site fp8
    quantization-health statistics (saturation, underflow, activation
    scale drift: ``repro_torch.obs.quant_health``).  Opt-in:
    ``REPRO_QUANT_HEALTH=1``."""
    return os.environ.get("REPRO_QUANT_HEALTH", "0").strip() == "1"


def quant_health_every() -> int:
    """``REPRO_QUANT_HEALTH_EVERY``: the engine runs the
    health-instrumented step variant once every this many calls of a
    step shape plus one (default 16, at least 1; a value that is not an
    integer gives 16)."""
    env = os.environ.get("REPRO_QUANT_HEALTH_EVERY", "").strip()
    try:
        return max(1, int(env)) if env else 16
    except ValueError:
        return 16


def trace_path() -> str | None:
    """``REPRO_TRACE``: the Chrome-trace output path, or None (tracing
    off).  Read once, by ``repro_torch.obs.trace.get_tracer``."""
    env = os.environ.get("REPRO_TRACE", "").strip()
    return env or None


# KV-cache storage dtype (models.attention.resolve_kv_cache_dtype): the
# configs default to "fp8"; REPRO_KV_CACHE overrides every config in
# both directions
KV_CACHE_DTYPES = ("bf16", "fp8")


def kv_cache_override() -> str | None:
    """``REPRO_KV_CACHE``, the override of the KV-cache storage dtype, or
    None to take the config's."""
    env = os.environ.get("REPRO_KV_CACHE", "").strip()
    if not env:
        return None
    if env not in KV_CACHE_DTYPES:
        raise ValueError(f"REPRO_KV_CACHE={env!r}: expected one of "
                         f"{KV_CACHE_DTYPES}")
    return env


MOE_EXPERT_PATHS = ("grouped", "vmapped")


def moe_expert_path() -> str:
    """The MoE expert path of moss and bf16 training and prefill
    (``REPRO_MOE_EXPERTS``, the reference's A/B switch): ``grouped``
    (the default: the grouped kernels, three launches a block) or
    ``vmapped`` (one expert at a time through ``qlinear``, as the
    baselines and the serving modes always run).  Another value raises
    ``ValueError``."""
    env = os.environ.get("REPRO_MOE_EXPERTS", "").strip()
    if env and env not in MOE_EXPERT_PATHS:
        raise ValueError(f"REPRO_MOE_EXPERTS={env!r}: expected one of "
                         f"{MOE_EXPERT_PATHS}")
    return env or "grouped"


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
