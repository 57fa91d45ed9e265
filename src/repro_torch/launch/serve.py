"""Serving CLI: drives the port's paged continuous-batching engine on
random weights made from a seed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --requests 8 --max-new 16              # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.layers import init_tree
from repro_torch.models.transformer import model_defs
from repro_torch.serving import Engine, Request


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> list[Request]:
    """Mixed prompt lengths in [prompt_len // 2, prompt_len]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(4, prompt_len // 2), prompt_len + 1, size=n)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=int(k),
                                        dtype=np.int32),
                    max_new=max_new)
            for i, k in enumerate(lens)]


def random_params(cfg, seed: int, device) -> dict:
    """The model's parameters from ``seed`` with a torch Generator on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_tree(model_defs(cfg), gen, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool budget (default: fully backed slots)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.max_new, args.seed)
    # a whole number of pages that holds prompt + max_new
    need = args.prompt_len + args.max_new
    max_len = -(-need // args.page_size) * args.page_size
    engine = Engine(cfg, random_params(cfg, args.seed, device), args.slots,
                    max_len=max_len, page_size=args.page_size,
                    num_pages=args.num_pages, device=device)
    print(f"path: paged continuous-batching engine on {device}")
    engine.run(reqs)
    return engine


if __name__ == "__main__":
    main()
