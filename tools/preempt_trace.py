"""Where a preempting pool's streams part from a fully backed pool's.

chip_smoke.py's preempt scenario (full-width phi3-mini, 4 slots,
max_len 128, 8 requests of 16-48 prompt and 64 new tokens) at a cut
depth: first on a fully backed pool, recording for one request (``--rid``)
at every decode step its depth, its fed token, its logits row and its
K/V (payloads and per-token scales, every layer, gathered in position
order through its block table); then on the 12-page pool that preempts,
comparing each of that request's decode steps with the record at the
same depth.  At the first step whose logits differ it prints what
differed among depth, token, K/V (the first field, layer and position),
the batch rows and depths of both runs, and then replays that step for
the request alone (B 1) and as row 0 of four copies of itself (B 4),
every quantized linear, norm, RoPE and decode-attention call recorded:
the first call whose row-0 output differs between B 1 and B 4, if any.
Needs a card.

    python3 tools/preempt_trace.py [--layers 8] [--rid 7]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _kv_rows(torch, caches, r: int, depth: int) -> list:
    """Row ``r``'s K/V for positions < ``depth``: per segment and pool
    tensor, (depth, L, KV, ...) bytes gathered through its block table."""
    from repro_torch.models.attention import _bytes
    from repro_torch.serving.paged_cache import _leaves

    out = []
    for pool in caches.values():
        t = pool.k.shape[3]
        pos = torch.arange(depth, device=pool.block_table.device)
        page = pool.block_table[r].long()[pos // t]
        for buf in _leaves(pool):
            out.append(_bytes(buf)[:, page, :, pos % t].clone().cpu())
    return out


def _first_call_diff(rec_a, rec_b, what: str) -> None:
    for i, ((kind, xa, ya), (_, xb, yb)) in enumerate(zip(rec_a, rec_b)):
        if not torch_equal(ya, yb):
            print(f"{what}: first parting call {i} of {len(rec_a)} "
                  f"({kind}), input equal {torch_equal(xa, xb)}, "
                  f"{int((ya != yb).sum())} of {ya.numel()} apart, max |d| "
                  f"{float((ya - yb).abs().max()):.3g} of "
                  f"{float(ya.abs().max()):.3g}")
            return
    print(f"{what}: all {len(rec_a)} calls equal")


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _first_kv_diff(torch, a: list, b: list) -> str:
    names = ("k", "v", "k_scale", "v_scale")
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            d = (x != y).nonzero()[0].tolist()
            return (f"field {names[i % 4]} differs first at position "
                    f"{d[0]}, layer {d[1]} ({int((x != y).sum())} bytes)")
    return "equal"


def _recording(torch, record: list, row: int = 0):
    """Patch the model's quantized linears, norms, RoPE and decode
    attention to append (kind, input row ``row``, output row ``row``)
    to ``record``; returns the undo list."""
    from repro_torch.core import linear
    from repro_torch.kernels import dispatch
    from repro_torch.models import attention, layers

    patched = []

    def wrap(mod, name, arg):
        f = getattr(mod, name)

        def g(*a, **k):
            out = f(*a, **k)
            record.append((name, a[arg][row].detach().float().cpu(),
                           out[row].detach().float().cpu()))
            return out
        setattr(mod, name, g)
        patched.append((mod, name, f))

    wrap(linear, "qlinear", 0)
    wrap(layers, "qlinear", 0)
    wrap(layers, "rmsnorm", 0)
    wrap(attention, "apply_rope", 0)
    wrap(dispatch, "decode_attention_paged", 0)
    return patched


def _replay(torch, eng, caches, r: int, tok: int, rows: int) -> list:
    """Row ``r``'s decode step as row 0 of ``rows`` copies of itself
    (each copy writes the same bytes to the same slot), calls recorded."""
    one = {n: c._replace(idx=c.idx[r:r + 1].repeat(rows).clone(),
                         block_table=c.block_table[r:r + 1].repeat(rows, 1)
                         .contiguous())
           for n, c in caches.items()}
    record = []
    patched = _recording(torch, record)
    try:
        logits, _ = eng.decode(eng.params, one,
                               torch.full((rows, 1), tok, dtype=torch.int32,
                                          device="cuda"))
    finally:
        for mod, name, f in patched:
            setattr(mod, name, f)
    return record, logits[0].float().cpu()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--rid", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.serving import Request

    cs.phase_card(torch)
    cs.phase_build()
    rid = args.rid
    records, traced = {}, {"depth": None}

    def run(label, num_pages, compare):
        eng = cs._engine(layers=args.layers, max_len=cs.PREEMPT_MAX_LEN,
                         num_pages=num_pages)
        step = eng.decode
        state = {"parted": None}

        def decode(params, caches, toks):
            kv = eng.kv
            if toks.shape[1] != 1 or rid not in kv.rows or \
                    state["parted"] is not None:
                return step(params, caches, toks)
            r = kv.rows.index(rid)
            depth = kv.lengths[r]
            tok = int(toks[r, 0])
            batch = list(zip(kv.rows, kv.lengths))
            if compare == "trace":
                if depth != traced["depth"]:
                    return step(params, caches, toks)
                rec = []
                patched = _recording(torch, rec, r)
                try:
                    logits, new = step(params, caches, toks)
                finally:
                    for mod, name, f in patched:
                        setattr(mod, name, f)
                _first_call_diff(rec, traced["rec1"], f"fully backed "
                                 f"(B {len(batch)}, rows {batch}) against "
                                 "the preempting step replayed at B 1")
                state["parted"] = depth
                return logits, new
            kvb = _kv_rows(torch, caches, r, depth)
            logits, new = step(params, caches, toks)
            row = logits[r, -1].float().cpu()
            if compare is None:
                records[depth] = (tok, kvb, row, batch)
                return logits, new
            want = compare.get(depth)
            if want is not None and not torch.equal(row, want[2]):
                state["parted"] = depth
                print(f"{label}: request {rid} parts at depth {depth} "
                      f"(max |d logits| "
                      f"{float((row - want[2]).abs().max()):.4g} of "
                      f"{float(want[2].abs().max()):.4g}); token "
                      f"{tok} against {want[0]}; K/V "
                      f"{_first_kv_diff(torch, kvb, want[1])}; rows "
                      f"(rid, depth) here {batch}, fully backed "
                      f"{want[3]}; block table row "
                      f"{caches['blocks'].block_table[r].tolist()}")
                rec1, l1 = _replay(torch, eng, caches, r, tok, 1)
                rec4, l4 = _replay(torch, eng, caches, r, tok, 4)
                print(f"replay: logits B 1 equal this step's "
                      f"{torch.equal(l1, row)}, B 4 row 0 equal B 1 "
                      f"{torch.equal(l1, l4)}, B 1 equal the fully "
                      f"backed row {torch.equal(l1, want[2])}")
                _first_call_diff(rec1, rec4, "replay B 1 against B 4")
                traced["rec1"] = rec1
            return logits, new

        eng.decode = decode
        reqs = cs._preempt_requests(Request, np, eng.cfg.vocab)
        eng.run(reqs, log=None)
        st = eng.stats()
        print(f"{label}: {args.layers} layers, preemptions "
              f"{st['preemptions']}, decode steps {st['decode_steps']}, "
              f"request {rid} out {list(reqs[rid].out)}")
        out = [list(r.out) for r in reqs]
        del eng
        torch.cuda.empty_cache()
        return out, state["parted"]

    full, _ = run("fully backed", None, None)
    small, parted = run("preempting", cs.PREEMPT_PAGES, records)
    if parted is not None:
        traced["depth"] = parted
        run("fully backed, traced", None, "trace")
    same = [a == b for a, b in zip(small, full)]
    print(f"streams equal per request: {same}; first parting depth of "
          f"request {rid}: {parted}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
