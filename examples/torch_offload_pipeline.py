"""Offload patterns beyond Fig. 2 on the PyTorch port: reverse offload,
relay (offload over fabric), fire-and-forget, and int8-compressed tensors
as message payloads.  The host's tensors live on the card unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
raises:

    python examples/torch_offload_pipeline.py [--device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.closure import f2f
from repro_torch.core.migratable import as_numpy
from repro_torch.core.registry import handler, init
from repro_torch.models.api import resolve_device
from repro_torch.offload.api import OffloadDomain, deref
from repro_torch.offload.runtime import current_node
from repro_torch.optim.compression import CompressedTensor


@handler(mutates=True)
def stage_scale(ptr, alpha):
    """Writes its buffer in place: declared, so replicas are invalidated."""
    torch.from_numpy(deref(ptr)).mul_(alpha)


@handler
def reverse_report(host_node, value):
    """Worker -> host callback (reverse offload)."""
    node = current_node()
    fut = node.send_async(host_node, f2f("_ham/ping", int(value)))
    return node.wait(fut, 10.0)


@handler(read_only=True)
def receive_compressed(ct):
    """Gradient-style payload: int8 + scale on the wire, fp32 at use."""
    return float(np.linalg.norm(ct.decompress()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    init()
    dom = OffloadDomain.local(num_nodes=3)

    # pipeline: host puts data on node 1, node-hops work 1 -> 2
    data = torch.linspace(0, 1, 4096, dtype=torch.float64, device=device)
    ptr = dom.allocate(1, tuple(data.shape), "float64")
    dom.put(data, ptr)
    dom.sync(1, f2f(stage_scale, ptr, 2.0))
    scaled = torch.from_numpy(dom.get(ptr)).to(device)
    assert torch.equal(scaled, 2.0 * data)
    print("stage 1 done; relay stage 2 via node 1 -> node 2")
    fut = dom.relay(via=1, dst=2, function=f2f("_ham/ping", 99))
    print("relay reply:", fut.get(10))

    # reverse offload: the worker calls back into the host mid-handler
    print("reverse offload:", dom.sync(2, f2f(reverse_report, 0, 42)))

    # compressed tensor payload (the migratable<T> hook in action): the
    # gradient is made on the device and compressed from its host copy
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(65536).astype(np.float32)).to(device)
    ct = CompressedTensor.compress(as_numpy(g))
    remote_norm = dom.sync(1, f2f(receive_compressed, ct))
    exact = float(torch.linalg.vector_norm(g.double()))
    print(f"compressed-grad norm on worker: {remote_norm:.2f} "
          f"(exact {exact:.2f}; wire {len(ct.encode()) / (4 * g.numel()):.0%} of fp32)")

    dom.shutdown()
    print(f"OK ({device.type})")


if __name__ == "__main__":
    main()
