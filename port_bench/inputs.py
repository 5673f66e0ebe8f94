"""The inputs of a run, made from ``--seed``: weights, tiles, orders.

Both sides get the same: the program's model loads the weights, and the
reference reads the same tensors.  Weights and tiles are made on the device
with a ``torch.Generator`` in a few large calls; the tiles then go to host
memory, where the program's loader reads them as a user's dataset would.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
TILE_CHUNK = 64           # tiles made on the device at a time
CELL_PX = 32              # side of a label region of a synthetic tile
NOISE_STD = 24.0          # pixel noise around a class's colour, in uint8 steps


def data_seed(seed: int) -> int:
    """``--seed`` as the non-negative 63-bit seed the generators and the
    trainer's ``Config.SEED`` take."""
    return int(seed) & _MASK63


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed's inputs."""
    mixed = np.random.SeedSequence([data_seed(seed), stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & _MASK63)


@torch.no_grad()
def make_weights(spec, seed: int, device) -> dict:
    """Every parameter and BatchNorm buffer of a weight ``spec`` (an
    architecture's ``weight_spec(cfg)``), float32:
    He-normal convs (``head``: LeCun-normal), BatchNorm scale U(0.5, 1.5)
    (U(0, 0.5) for the last norm of a residual branch), bias, running
    mean and head bias N(0, 0.1), running var U(0.5, 2)."""
    g = generator(seed, 0, device)
    kernels = [(n, s, k) for n, s, k in spec if k in ("conv", "head")]
    vectors = [(n, s, k) for n, s, k in spec if k not in ("conv", "head")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in kernels), generator=g, device=device)
    uni = torch.rand(sum(math.prod(s) for _, s, _ in vectors), generator=g, device=device)
    nrm = torch.randn(uni.numel(), generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in kernels:
        n = math.prod(shape)
        fan_in = n // shape[0]
        gain = 2.0 if kind == "conv" else 1.0
        out[name] = (flat[off:off + n] * math.sqrt(gain / fan_in)).view(shape)
        off += n
    off = 0
    for name, shape, kind in vectors:
        n = math.prod(shape)
        u, z = uni[off:off + n].view(shape), nrm[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[1]
        if leaf == "scale":
            out[name] = 0.5 * u if kind == "bn_last" else 0.5 + u
        elif leaf == "var":
            out[name] = 0.5 + 1.5 * u
        else:                                   # bias, mean, the head's bias
            out[name] = 0.1 * z
    return {name: out[name].contiguous() for name, _, _ in spec}


@torch.no_grad()
def make_tiles(seed: int, n: int, tile: int, classes: int, device):
    """``n`` distinct synthetic aerial tiles as host numpy arrays: uint8
    (n, tile, tile, 3) images and int32 (n, tile, tile) masks.  A mask is
    a grid of ``CELL_PX`` regions with a class each; its image is the
    class's colour (one random palette) plus Gaussian pixel noise."""
    g = generator(seed, 1, device)
    palette = torch.randint(0, 256, (classes, 3), generator=g, device=device).float()
    cells = max(tile // CELL_PX, 1)
    images = np.empty((n, tile, tile, 3), np.uint8)
    masks = np.empty((n, tile, tile), np.int32)
    for start in range(0, n, TILE_CHUNK):
        k = min(TILE_CHUNK, n - start)
        coarse = torch.randint(0, classes, (k, cells, cells), generator=g, device=device)
        rep = -(-tile // cells)
        mask = coarse.repeat_interleave(rep, 1).repeat_interleave(rep, 2)[:, :tile, :tile]
        noise = torch.randn((k, tile, tile, 3), generator=g, device=device)
        img = torch.clamp(palette[mask] + NOISE_STD * noise, 0.0, 255.0).round()
        images[start:start + k] = img.to(torch.uint8).cpu().numpy()
        masks[start:start + k] = mask.to(torch.int32).cpu().numpy()
    return images, masks


def orders(seed: int, n: int):
    """Indices into a ring of ``n`` tiles without end: seeded permutations
    of the ring one after the other, so any ``n`` in a row are distinct."""
    rng = np.random.default_rng([data_seed(seed), 2])
    while True:
        yield from rng.permutation(n).tolist()


def order(seed: int, n: int, length: int) -> list:
    """The first ``length`` indices of ``orders``."""
    return list(itertools.islice(orders(seed, n), length))
