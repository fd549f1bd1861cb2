"""Error-feedback gradient compression (int8), port of
``repro.optim.compression``: a ``migratable`` specialisation in the sense
of the paper.  A type that cannot be bitwise copied efficiently (float32
gradients) gets a serialisation hook that quantises on encode and
dequantises on decode, with the residual kept locally so the compression
error is fed back into the next round (EF-SGD).

Used two ways:
* inside the training step (``train.step.build_compressed_train_step``),
  on the gradient tree;
* as a HAM message payload: :class:`CompressedTensor` is a numpy copy of
  the reference's, registered migratable under the same type name
  (``ham:compressed_tensor``), so its frames are the reference's.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from repro_torch.core.migratable import register_migratable
from repro_torch.optim.adamw import tree_leaves, tree_map

# --------------------------------------------------------------------------
# tensor-side int8 quantisation with error feedback
# --------------------------------------------------------------------------


def quantize_int8(x):
    """Per-tensor symmetric int8.  Returns (q int8, scale float32)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def ef_compress_tree(grads, residual):
    """Error feedback: quantise (g + residual), carry the new residual."""
    def leaf(g, r):
        x = g.float() + r
        q, s = quantize_int8(x)
        return (q, s), x - dequantize_int8(q, s)

    pairs = [leaf(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    it_q, it_r = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return tree_map(lambda _: next(it_q), grads), tree_map(lambda _: next(it_r), grads)


def ef_decompress_tree(qtree):
    if isinstance(qtree, tuple) and len(qtree) == 2 and isinstance(qtree[0], torch.Tensor):
        return dequantize_int8(*qtree)
    if isinstance(qtree, dict):
        return {k: ef_decompress_tree(qtree[k]) for k in sorted(qtree)}
    return type(qtree)(ef_decompress_tree(t) for t in qtree)


def ef_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# --------------------------------------------------------------------------
# wire-side: CompressedTensor as a migratable type
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedTensor:
    """int8 payload + scale + original shape; 4x smaller than fp32 wire."""

    q: np.ndarray       # int8
    scale: float
    shape: tuple

    @staticmethod
    def compress(x: np.ndarray) -> "CompressedTensor":
        x = np.asarray(x, np.float32)
        amax = float(np.max(np.abs(x))) + 1e-12
        scale = amax / 127.0
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        return CompressedTensor(q.reshape(-1), scale, tuple(x.shape))

    def decompress(self) -> np.ndarray:
        return (self.q.astype(np.float32) * self.scale).reshape(self.shape)

    def encode(self) -> bytes:
        hdr = struct.pack("<dB", self.scale, len(self.shape))
        dims = struct.pack(f"<{len(self.shape)}q", *self.shape)
        return hdr + dims + self.q.tobytes()

    @staticmethod
    def decode(raw: bytes) -> "CompressedTensor":
        scale, ndim = struct.unpack_from("<dB", raw, 0)
        off = 9
        shape = struct.unpack_from(f"<{ndim}q", raw, off)
        off += 8 * ndim
        q = np.frombuffer(raw, np.int8, offset=off)
        return CompressedTensor(q.copy(), scale, tuple(shape))


register_migratable(
    CompressedTensor,
    encode=lambda t: t.encode(),
    decode=CompressedTensor.decode,
    type_name="ham:compressed_tensor",
)
