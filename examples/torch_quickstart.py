"""Quickstart on the PyTorch port: HAM in 60 lines — the paper's Fig. 2
program, with the host's data in torch tensors.

Registers handlers (static initialisation), seals the key map (init), spins
up an offload domain with one worker, and runs the inner-product offload.
The host's tensors live on the card unless ``--device cpu`` is given (a
CUDA tensor travels through pinned host memory); without a card and
without ``--device cpu`` it raises:

    python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core.closure import f2f
from repro_torch.core.registry import handler, init
from repro_torch.models.api import resolve_device
from repro_torch.offload.api import OffloadDomain, deref


# --- static initialisation: register handlers (every process, same source)
@handler(read_only=True)
def inner_prod(a_ptr, b_ptr, n):
    a = torch.from_numpy(deref(a_ptr))       # valid on the owning node only
    b = torch.from_numpy(deref(b_ptr))
    return float(a[:n] @ b[:n])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    table = init()                           # sort -> keys, no communication
    print(f"handler table: {len(table)} handlers, "
          f"digest {table.digest.hex()[:16]}…")

    dom = OffloadDomain.local(num_nodes=2)   # host + one worker
    target = 1

    # host memory: tensors on the chosen device
    n = 1024
    a = torch.arange(n, dtype=torch.float64, device=device)
    b = torch.full((n,), 0.5, dtype=torch.float64, device=device)

    # target memory (PGAS buffer_ptr smart pointers)
    a_t = dom.allocate(target, (n,), "float64")
    b_t = dom.allocate(target, (n,), "float64")
    dom.put(a, a_t)
    dom.put(b, b_t)

    # async offload, returns a future
    result = dom.async_(target, f2f(inner_prod, a_t, b_t, n))
    # ... do something in parallel on the host ...
    expected = float(a @ b)
    c = result.get(timeout=10)
    print(f"inner product on worker: {c}   (expected {expected})")
    assert c == expected

    dom.shutdown()
    print(f"OK ({device.type})")


if __name__ == "__main__":
    main()
