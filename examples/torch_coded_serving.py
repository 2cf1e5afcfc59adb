"""Coded LM-head serving under injected stragglers, through the PyTorch port.

    PYTHONPATH=src python examples/torch_coded_serving.py [--device cpu]

Serves batched greedy decoding from a small dense LM where the final
unembedding matvec — exactly the paper's workload shape — runs through
an (n, k) MDS code over a heterogeneous simulated fleet: the coded
vocab blocks are encoded once by the B3 kernel and every decode step's
block mix runs through B1. Workers that miss the deadline (T* x safety
factor, from the paper's Theorem 2) are erasures; logits are recovered
from any k surviving coded blocks. Exits non-zero unless the coded
tokens equal the uncoded ones.

The counterpart of ``examples/coded_serving.py``; on the card unless
``--device cpu``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.runtime_model import ClusterSpec  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.serve_loop import ServeConfig, Server  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--trials", type=int, default=200, help="finish masks drawn")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    config = get_arch("qwen3-0.6b").reduced()
    model = Model(config, device=dev)

    # 12 workers in two speed groups; the slow group straggles hard.
    fleet = ClusterSpec.make([6, 6], [8.0, 0.7])
    server = Server(model, fleet, ServeConfig(block_rows=64))
    head = server.coded_head
    print(f"coded LM head: V={config.vocab_size} -> kb={head.kb} blocks, "
          f"(n,k)=({head.nb},{head.kb}) rate={head.kb / head.nb:.3f}")
    print(f"per-worker block loads (Theorem 2): {head.plan.loads_per_worker.tolist()}")
    print(f"deadline = T* x 3 = {head.deadline:.4f}")

    # how often does the fleet miss (insufficient survivors)?
    loads = torch.as_tensor(head.plan.loads_per_worker, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    misses = sum(int((loads * head.finish_mask(gen)).sum()) < head.kb
                 for _ in range(args.trials))
    print(f"decode-failure rate at this deadline: {misses / args.trials:.1%}")

    prompts = torch.randint(0, config.vocab_size, (4, 8),
                            generator=torch.Generator().manual_seed(7)).to(torch.int32)
    t0 = time.perf_counter()
    out_coded = server.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    print(f"coded generate: {prompts.shape[0] * args.max_new / dt:.1f} tok/s")
    plain = Server(model, None, ServeConfig())
    out_plain = plain.generate(prompts, max_new=args.max_new)
    match = bool(torch.equal(out_coded.cpu(), out_plain.cpu()))
    print(f"coded == uncoded greedy outputs: {match}")
    print("sample continuation:", out_coded[0, 8:].tolist())
    print("kernel launches:", json.dumps(kernels.launch_counts()))
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main())
