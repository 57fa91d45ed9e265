"""Delayed activation scales for serving (counterpart of
``repro.core.actscale``).

``calibrate_act_scales`` runs ONE forward over a fixed calibration
prompt when the engine is built, recording every quantized GEMM site's
per-micro-group activation amax; each site's statistics, times a
safety margin, become an ``ActScale`` in a flat ``{site tag: ActScale}``
dict keyed by the params-tree path (``"blocks/attn/wq"``), with the
stacked layer dim leading (then the expert dim of a MoE expert's site,
``"blocks/moe/w_up"``: (L, E) scales).  The serving steps then quantize
activations against these scales with no amax reduction
(``linear._qmm_delayed``).

The calibration forward is the same model code the serving steps run,
in train mode, one layer at a time (a MoE block takes its dense
combine, one expert at a time under ``REC.sub_index``): each quantized
``QT`` carries its site tag in ``a`` and ``qlinear`` reports its input
here.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .formats import TINY, QuantConfig, e8m0_encode, fp8_max

DEFAULT_MARGIN = 1.25
CALIBRATION_TOKENS = 32
_CAL_SEED = 0xAC5


class ActScale(NamedTuple):
    """One site's delayed activation scales (moss): ``s`` the f32
    level-1 scale and ``sub`` the (K/micro,) int8 E8M0 exponents, each
    with the site's stacked layer dim leading until sliced."""

    s: torch.Tensor
    sub: torch.Tensor | None = None


class _Recorder:
    """Calibration recorder: ``qlinear`` reports concrete per-site
    activation amaxes here while a calibration forward runs."""

    def __init__(self):
        self.recording = False
        self.index: tuple[int, ...] = ()
        self.stats: dict[str, dict[tuple[int, ...], np.ndarray]] = {}

    @contextlib.contextmanager
    def calibrating(self):
        self.recording, self.index, self.stats = True, (), {}
        try:
            yield self
        finally:
            self.recording = False

    @contextlib.contextmanager
    def at_index(self, idx: tuple[int, ...]):
        prev, self.index = self.index, idx
        try:
            yield
        finally:
            self.index = prev

    @contextlib.contextmanager
    def sub_index(self, i: int):
        """Append ``i`` to the current index: a MoE expert's sites record
        under (layer, expert)."""
        with self.at_index(self.index + (int(i),)):
            yield

    def record(self, tag: str, x: torch.Tensor, cfg: QuantConfig) -> None:
        """Accumulate the per-micro-group amax of activation ``x`` (the
        GEMM's left operand, inner dim last) for site ``tag`` at the
        current (layer[, expert]) index."""
        if cfg.mode != "moss":
            raise NotImplementedError(
                f"calibration for {cfg.mode!r}: ROADMAP next slices, "
                "serving the baselines")
        k = x.shape[-1]
        g = cfg.micro_group
        xf = x.detach().to(torch.float32).abs().reshape(-1, k)
        pad = (-k) % g
        if pad:
            xf = torch.nn.functional.pad(xf, (0, pad))
        amax = xf.reshape(xf.shape[0], -1, g).amax(dim=(0, 2))
        amax = amax.cpu().numpy()
        site = self.stats.setdefault(tag, {})
        prev = site.get(self.index)
        site[self.index] = (amax if prev is None
                            else np.maximum(prev, amax))


REC = _Recorder()


def path_tag(path) -> str:
    """Canonical site tag for a params-tree path: keys joined by "/"."""
    return "/".join(str(p) for p in path)


def _stack_site(per_idx: dict[tuple[int, ...], np.ndarray]) -> np.ndarray:
    """{(layer[, expert]) index: stat array} -> one stacked array whose
    leading dims mirror the site's stacked weight dims."""
    idxs = sorted(per_idx)
    depth = len(idxs[0])
    if depth == 0:
        return np.asarray(per_idx[()])
    dims = tuple(max(i[d] for i in idxs) + 1 for d in range(depth))
    if len(idxs) != int(np.prod(dims)):
        raise ValueError(f"sparse calibration grid: {len(idxs)} records "
                         f"for dims {dims}")
    flat = np.stack([np.asarray(per_idx[i]) for i in idxs])
    return flat.reshape(*dims, *flat.shape[1:])


def _to_scales(amax: np.ndarray, cfg: QuantConfig, margin: float,
               device) -> ActScale:
    """Calibrated amax statistics -> the moss ActScale: level-1 =
    margin · max_g s_g, level-2 = ceil-encoded E8M0 ratios (rounding up:
    never an underestimate)."""
    fmax = float(fp8_max(cfg.fwd_format))
    s_fine = (np.maximum(amax, TINY) / fmax).astype(np.float32)
    s1 = margin * np.maximum(s_fine.max(axis=-1), TINY)
    ratio = (margin * s_fine) / s1[..., None]
    sexp = e8m0_encode(torch.from_numpy(np.asarray(ratio, np.float32)))
    return ActScale(s=torch.as_tensor(s1, dtype=torch.float32,
                                      device=device),
                    sub=sexp.to(device))


def calibration_tokens(cfg, n: int = CALIBRATION_TOKENS) -> np.ndarray:
    """Deterministic calibration prompt, independent of engine geometry
    (the reference's: same seed, same draw)."""
    rng = np.random.default_rng(_CAL_SEED)
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            "embedding-input models: ROADMAP queue 1 item 11")
    return rng.integers(0, cfg.vocab, size=(1, n)).astype(np.int32)


def _tag_wrap(params: dict, scales: dict | None, mask: dict, path=()):
    """QT-wrap quantized leaves with their site tag riding in ``a``."""
    from .linear import QT

    out = {}
    for key, w in params.items():
        p = path + (key,)
        if isinstance(w, dict):
            out[key] = _tag_wrap(w, None if scales is None else scales[key],
                                 mask[key], p)
        elif mask[key]:
            out[key] = QT(w, None if scales is None else scales[key],
                          path_tag(p))
        else:
            out[key] = w
    return out


def _slice_layer(tree, l: int):
    """Index layer ``l`` out of a stacked segment subtree (QT tag
    strings pass through)."""
    from .linear import QT

    if isinstance(tree, QT):
        return QT(tree.w[l], None if tree.s is None else tree.s[l], tree.a)
    if isinstance(tree, dict):
        return {k: _slice_layer(v, l) for k, v in tree.items()}
    return tree[l]


@torch.inference_mode()
def calibrate_act_scales(cfg, params, scales=None, *, tokens=None,
                         margin: float = DEFAULT_MARGIN) -> dict | None:
    """One forward over the calibration prompt -> flat
    ``{site tag: ActScale}`` (None for unquantized recipes)."""
    qcfg = cfg.quant
    if not qcfg.quantized:
        return None
    from repro_torch.models.layers import apply_norm, embed_tokens, lm_head
    from repro_torch.models.transformer import build_segments
    from repro_torch.train.steps import serve_quant_mask

    device = params["embed"]["embedding"].device
    wrapped = _tag_wrap(params, scales, serve_quant_mask(cfg, params))
    if tokens is None:
        tokens = calibration_tokens(cfg)
    with REC.calibrating():
        x = embed_tokens(cfg, wrapped["embed"],
                         torch.as_tensor(tokens, dtype=torch.int64,
                                         device=device))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=device)
        for seg in build_segments(cfg):
            p_seg = wrapped[seg.name]
            for l in range(seg.n):
                with REC.at_index((l,)):
                    x, _, _ = seg.apply(cfg, qcfg, _slice_layer(p_seg, l),
                                        x, positions, None, "train")
        x = apply_norm(cfg, wrapped["final_norm"], x)
        lm_head(cfg, wrapped["embed"], x, qcfg)
        stats = REC.stats
    return {tag: _to_scales(_stack_site(per_idx), qcfg, margin, device)
            for tag, per_idx in stats.items()}
