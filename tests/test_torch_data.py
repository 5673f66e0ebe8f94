"""The port's data layer against the JAX package's (CPU).

Fixture files come from the JAX package's ``setup_test_data`` in a
temporary directory.  Both packages read them:

- ``WeightedRandomSampler``, ``random_split`` and ``Subset`` make the same
  numpy RNG calls: the index sequences are identical for every seed;
- ``DroneDataset.load_raw`` arrays are identical, decoded through the
  native decoder (both packages bind ``native/loader.cpp``) and through
  cv2; ``class_stats`` are equal dicts in the same order, ``sample_weights``
  equal to 1e-12 (the same float64 operations, so in fact bit for bit), and
  the cache JSON is the same text;
- ``DataLoader`` yields the same batches in the same order for 0 and 2
  worker threads, with and without ``drop_last``;
- ``prefetch_to_device`` on the CPU narrows masks to uint8 and raises on a
  later batch out of range, as the JAX prefetcher does.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu.config import Config as JaxConfig
from uda_aerial_semantic_segmentation_research_tpu.data import dataset as jax_dataset
from uda_aerial_semantic_segmentation_research_tpu.data import loader as jax_loader
from uda_aerial_semantic_segmentation_research_tpu.data import native as jax_native
from uda_aerial_semantic_segmentation_research_tpu.data.setup_test_data import (
    setup_test_data as jax_setup_test_data,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset, loader, native
from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
    setup_test_data,
)

N_TILES, TILE, CLASSES = 6, 40, 23


def _patch_paths(mp, cls, root):
    mp.setattr(cls, "DATA_DIR", str(root / "data"))
    mp.setattr(cls, "SAMPLE_DATA_DIR", str(root / "data" / "sample" / "semantic_drone"))
    mp.setattr(cls, "NUM_CLASSES", CLASSES)
    mp.setattr(cls, "SAMPLE_HOLYROOD_DIR", str(root / "data" / "sample" / "holyrood"))
    mp.setattr(cls, "TARGET_DATA_DIR", str(root / "data" / "target" / "holyrood"))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """(JAX fixture root, port fixture root): the same call in both packages."""
    roots = {}
    for name, cls, setup in (("jax", JaxConfig, jax_setup_test_data),
                             ("port", Config, setup_test_data)):
        root = tmp_path_factory.mktemp(name)
        with pytest.MonkeyPatch.context() as mp:
            _patch_paths(mp, cls, root)
            setup(num_source=N_TILES, num_holyrood=0, image_size=TILE, seed=42, force=True)
        roots[name] = root / "data"
    return roots["jax"], roots["port"]


def _dirs(root):
    sample = root / "sample" / "semantic_drone"
    return str(sample / "original_images"), str(sample / "label_images_semantic")


def test_setup_test_data_writes_the_jax_source_fixtures(fixtures):
    jroot, proot = fixtures
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert len(files) == 2 * N_TILES + 2                     # tiles, masks, two CSVs
    assert files == sorted(p.relative_to(proot) for p in proot.rglob("*") if p.is_file())
    for f in files:
        assert (jroot / f).read_bytes() == (proot / f).read_bytes(), f


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_sampler_split_and_subset_orders_match_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.random(17)
    for replacement in (True, False):
        a = dataset.WeightedRandomSampler(w, 9, replacement=replacement, seed=seed)
        b = jax_dataset.WeightedRandomSampler(w, 9, replacement=replacement, seed=seed)
        assert list(a) == list(b) and list(a) == list(b) and len(a) == len(b) == 9
    data = list(range(100, 117))
    ours = dataset.random_split(data, [10, 4, 3], seed=seed)
    theirs = jax_dataset.random_split(data, [10, 4, 3], seed=seed)
    for s, t in zip(ours, theirs):
        assert s.indices == t.indices
        assert [s[i] for i in range(len(s))] == [t[i] for i in range(len(t))]
    with pytest.raises(ValueError, match="sum of lengths"):
        dataset.random_split(data, [10, 4], seed=seed)
    with pytest.raises(ValueError, match="non-empty"):
        dataset.WeightedRandomSampler(np.ones((2, 2)), 3)


@pytest.fixture(params=[("native", 32), ("cv2", 32), ("cv2", None)],
                ids=["native-32", "cv2-32", "cv2-own-size"])
def decoder(request, monkeypatch):
    kind, size = request.param
    if kind == "cv2":
        monkeypatch.setattr(jax_native, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.available() and jax_native.available()
    return kind, size


def test_drone_dataset_matches_jax(fixtures, decoder):
    kind, size = decoder
    images_dir, masks_dir = _dirs(fixtures[0])
    cache = None

    def build(module):
        nonlocal cache
        for f in Path(masks_dir).glob(".class_stats_*.json"):
            f.unlink()
        ds = module.DroneDataset(images_dir, masks_dir, image_size=size, verbose=False)
        (cache,) = Path(masks_dir).glob(".class_stats_*.json")
        return ds, cache.read_text()

    jds, jcache = build(jax_dataset)
    pds, pcache = build(dataset)
    assert pcache == jcache
    assert list(pds.class_stats.items()) == list(jds.class_stats.items())
    np.testing.assert_allclose(pds.sample_weights, jds.sample_weights, rtol=0, atol=1e-12)
    assert len(pds) == len(jds) == N_TILES
    for i in range(N_TILES):
        (pi, pm), (ji, jm) = pds.load_raw(i), jds.load_raw(i)
        assert pi.dtype == ji.dtype == np.uint8 and pm.dtype == jm.dtype == np.int32
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pm, jm)
        assert pi.shape[:2] == (size or TILE,) * 2
    # the cache file written by either package is read by the other
    again = dataset.DroneDataset(images_dir, masks_dir, image_size=size, verbose=False)
    assert again.class_stats == jds.class_stats
    np.testing.assert_array_equal(again.sample_weights, pds.sample_weights)
    for indices in (None, [0, 2, 4]):
        a, b = pds.get_sampler(indices), jds.get_sampler(indices)
        np.testing.assert_allclose(a.probabilities, b.probabilities, rtol=0, atol=1e-12)


def test_drone_dataset_raw_cache_and_transform(fixtures):
    images_dir, masks_dir = _dirs(fixtures[1])
    ds = dataset.DroneDataset(images_dir, masks_dir, image_size=24, verbose=False,
                              transform=lambda image, mask: {"image": image[::-1],
                                                             "mask": mask + 1})
    assert ds.enable_raw_cache()
    first = ds.load_raw(1)
    assert ds.load_raw(1) is first
    image, mask = ds[1]
    np.testing.assert_array_equal(image, first[0][::-1])
    assert mask.dtype == np.int32 and (mask == first[1] + 1).all()
    assert not dataset.DroneDataset(images_dir, masks_dir, verbose=False).enable_raw_cache()
    unbalanced = dataset.DroneDataset(images_dir, masks_dir, balance_classes=False,
                                      verbose=False)
    assert unbalanced.get_sampler() is None


def _loaders(fixtures, num_workers, drop_last, order):
    """(port loader, JAX loader) over the same 5-tile training split."""
    images_dir, masks_dir = _dirs(fixtures[0])
    out = []
    for dmod, lmod in ((dataset, loader), (jax_dataset, jax_loader)):
        ds = dmod.DroneDataset(images_dir, masks_dir, image_size=32, verbose=False)
        train, _ = dmod.random_split(ds, [5, 1], seed=3)
        kw = {}
        if order == "shuffle":
            kw = {"shuffle": True, "seed": 5}
        elif order == "sampler":
            kw = {"sampler": dmod.WeightedRandomSampler(ds.sample_weights[train.indices], 5,
                                                        seed=9)}
        out.append(lmod.DataLoader(train, batch_size=2, drop_last=drop_last,
                                   num_workers=num_workers, **kw))
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(fixtures, num_workers, drop_last):
    for order in ("sequential", "shuffle", "sampler"):
        ours, theirs = _loaders(fixtures, num_workers, drop_last, order)
        assert len(ours) == len(theirs) == (2 if drop_last else 3)
        for epoch in range(2):                     # a shuffle draws anew each epoch
            for method in ("iter_raw", "__iter__"):
                a, b = list(getattr(ours, method)()), list(getattr(theirs, method)())
                assert len(a) == len(b) == len(ours), (order, method)
                for (ai, am), (bi, bm) in zip(a, b):
                    np.testing.assert_array_equal(ai, bi)
                    np.testing.assert_array_equal(am, bm)


def test_loader_surfaces_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise OSError("cannot decode tile 2")
            return np.zeros(3)

    with pytest.raises(OSError, match="tile 2"):
        list(loader.DataLoader(Broken(), batch_size=1, num_workers=2))


def test_prefetch_narrows_masks_and_checks_later_batches():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8) for _ in range(3)]
    masks = [rng.integers(0, 23, (2, 4, 4)).astype(np.int32) for _ in range(3)]
    out = list(loader.prefetch_to_device(zip(images, masks), "cpu", size=2))
    assert len(out) == 3
    for (pi, pm), i, m in zip(out, images, masks):
        assert isinstance(pi, torch.Tensor) and pi.dtype == torch.uint8
        assert pm.dtype == torch.uint8
        np.testing.assert_array_equal(pi.numpy(), i)
        np.testing.assert_array_equal(pm.numpy(), m)
    bad = masks[:1] + [np.full((2, 4, 4), 256, np.int32)]
    it = loader.prefetch_to_device(zip(images, bad), "cpu", size=1)
    next(it)
    with pytest.raises(ValueError, match=r"outside \[0, 256\)"):
        next(it)
    # the JAX prefetcher makes the same decision on the same batches
    jit = jax_loader.prefetch_to_device(zip(images, bad), size=1)
    assert np.asarray(next(jit)[1]).dtype == np.uint8
    with pytest.raises(ValueError, match=r"outside \[0, 256\)"):
        next(jit)
    # a first batch out of range keeps the masks wide; no narrowing when asked
    wide = [np.full((2, 4, 4), -1, np.int64), masks[0].astype(np.int64)]
    kept = [m.dtype for _, m in loader.prefetch_to_device(zip(images, wide), "cpu")]
    assert kept == [torch.int64, torch.int64]
    kept = [m.dtype for _, m in loader.prefetch_to_device(zip(images, masks), "cpu",
                                                           cast_masks_uint8=False)]
    assert kept == [torch.int32] * 3
    single = list(loader.prefetch_to_device(iter(images), "cpu"))
    assert [t.shape for t in single] == [torch.Size([2, 4, 4, 3])] * 3


def test_native_decoder_builds_under_the_build_directory():
    assert native.available()
    assert list(native.BUILD_DIR.glob("libuda_loader_*.so"))
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert os.path.realpath(native._SRC) == os.path.realpath(jax_native._SRC)
