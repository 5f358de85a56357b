"""Serving demo on the PyTorch port: batched greedy decode with the
production decode path (the per-kind KV / conv / SSD-state cache, one
step per token) on a reduced arch.  The port of ``examples/serve_demo.py``.

    PYTHONPATH=src python examples/torch_serve_demo.py --arch tinyllama-1.1b --tokens 16
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu

Works for the hybrid and SSM archs too (mamba2-780m, jamba-v0.1-52b):
their decode carries conv and SSD state instead of (or beside) KV.  Runs
on the CUDA device unless ``--device`` says otherwise, and raises without
one.  The first token of each sequence is the reference's
``jax.random.randint(key(0), (batch, 1), 2, vocab)``, bit for bit.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_reduce
from repro_torch.models import build_model
from repro_torch.utils import prng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = smoke_reduce(get_config(args.arch))
    api = build_model(cfg, device=args.device)
    params = api.init_params(0)
    cache = api.init_decode_cache(args.batch, args.max_seq)

    tok = prng.randint(prng.key(0, device=api.device), (args.batch, 1), 2,
                       cfg.vocab_size)
    out_tokens = [tok[:, 0].cpu().numpy()]
    logits, cache = api.decode_step(params, cache, tok, 0)   # warm-up
    on_card = api.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(api.device)
    t0 = time.perf_counter()
    for pos in range(1, args.tokens):
        tok = torch.argmax(logits, -1)[:, None]
        logits, cache = api.decode_step(params, cache, tok, pos)
        out_tokens.append(tok[:, 0].cpu().numpy())
    dt = time.perf_counter() - t0
    rate = args.batch * (args.tokens - 1) / dt
    where = torch.cuda.get_device_name(api.device) if on_card else "CPU"
    print(f"arch={cfg.name} (reduced): decoded {args.tokens} tokens x "
          f"batch {args.batch} -> {rate:.1f} tok/s on {where}")
    print("sequences (greedy):")
    seq = np.stack(out_tokens, axis=1)
    for row in seq:
        print(" ", row[:16].tolist())
    assert bool(torch.isfinite(logits).all())
    return seq


if __name__ == "__main__":
    main()
