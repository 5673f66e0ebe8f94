"""The port's scan driver (``training.steps.make_scan_driver``) and what a
CUDA graph of a train step needs from the rest of the port.

On the CPU (the scan driver runs the S steps one after another there):
- against the JAX ``make_scan_driver`` on the same weights, ``aug_cfg=NONE``
  on both sides, S=3 different batches (resnet18 U-Net, 64 px, 7 classes,
  B=2): the per-step losses within 1e-4 relative, the parameters after the
  S steps by the Adam-sign rule of ``tests/test_torch_train_step.py`` after
  more than one step (every entry within ``2.5 * lr`` a step, at most 10% of
  the entries off by more than ``0.1 * lr``; ``lr`` 1e-6);
- against S sequential calls of the port's step, bit for bit (metrics,
  parameters, buffers, Adam state, step counter), for the supervised step,
  the phase-2 step, the phase-3 step with an ``(S,)`` ``epoch`` and the GRL
  step with an ``(S,)`` ``alpha`` (the sequential calls take Python
  numbers), drawing from one seeded generator;
- the stacked metrics' shapes, ``state.step`` advanced by S, the errors for
  a mismatched leading axis and a per-step Python scalar;
- ``FineTuningLoss.rampup`` of a tensor against the host version, bit for
  bit, and every kernel wrapper's capture guard (the capture simulated);
- ``optax.adam``'s arithmetic written out in float64 numpy against optax
  over three updates (1e-6, ``tests/test_torch_train_step.py``'s Adam
  tolerance), so that the card's test can hold the capturable Adam to it.

On the card (``-m gpu``; they skip here): the scan driver's CUDA graphs against
eager steps of the same capturable state and generator, bit for bit with
cuDNN's deterministic algorithms; replays across calls; the generator's
registration; a capture's refusals (and a process group's: NCCL's
collectives are captured with the step, gloo on the card refuses); the
capturable Adam (foreach, and fused
with the phase-3 ``found_inf``; its bias corrections on the device in
float32) against that numpy Adam over three updates, 1e-6.  JAX is imported only inside the test
that compares against it, so the GPU tests run on a machine without JAX or
flax: ``python -m pytest --noconftest -m gpu tests/test_torch_scan_driver.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    DomainAdaptationModel,
    create_discriminator,
    create_uda_model,
    create_unet,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
    _build,
    augment,
    channel_sums,
    conv_bn_relu,
    dihedral,
    losses,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps
from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
    adam,
)

# the WEAK pipeline with every stage after the dihedral one off, in float32
# (tests/test_torch_adversarial.py's PCFG): the draws still come from the generator
PCFG = dataclasses.replace(augment.WEAK, compute_dtype="float32", p_ssr=0.0, p_distort=0.0,
                           p_noise=0.0, p_blur=0.0, p_color=0.0, p_hsv=0.0)
CLASSES, BATCH, SIZE, S = 7, 2, 32, 3
JAX_SIZE = 64      # tests/test_torch_train_step.py's: the deepest BatchNorm sees 8 values
LR = 1e-6
EPOCHS = (3.0, 17.5, 45.0)          # the last one past the ramp-up
ALPHAS = (0.25, 0.5, 1.0)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's small tensors (the tier-1 run
    has six workers on eight cores; tests/test_torch_adversarial.py).
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, n=S, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (n, BATCH, size, size, 3),
                                                dtype=np.uint8)


def _masks(seed, n=S, size=SIZE):
    return np.random.default_rng(seed).integers(0, CLASSES, (n, BATCH, size, size)).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# against the JAX scan driver
# ---------------------------------------------------------------------------
@functools.cache
def _jax_vs_port():
    import jax
    import jax.numpy as jnp

    from tests.test_torch_train_step import _flat, _jax_state, _port_model, _weights
    from uda_aerial_semantic_segmentation_research_tpu.ops import augment as jax_augment
    from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state
    from uda_aerial_semantic_segmentation_research_tpu.training import steps as jax_steps

    module, flat = _weights()
    images, masks = _images(1, size=JAX_SIZE), _masks(2, size=JAX_SIZE)
    tx = jax_state.adam(LR)
    jstep = jax_steps.make_supervised_train_step(module, CLASSES, aug_cfg=jax_augment.NONE)
    multi = jax_steps.make_scan_driver(jstep)
    jstate, jm = multi(_jax_state(flat, tx), jax.random.key(7), jnp.asarray(images),
                       jnp.asarray(masks))
    theirs = dict(metrics={k: np.array(v) for k, v in jm.items()}, step=int(jstate.step),
                  state=_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))

    model = _port_model(flat)
    state = TrainState(model, adam(LR))
    pmulti = steps.make_scan_driver(steps.make_supervised_train_step(model, CLASSES,
                                                                     aug_cfg=augment.NONE))
    state, pm = pmulti(state, None, images, masks)
    ours = dict(metrics={k: v.numpy() for k, v in pm.items()}, step=state.step,
                state=to_jax_state_dict(model))
    return theirs, ours, flat


def test_scan_driver_losses_match_jax():
    theirs, ours, _ = _jax_vs_port()
    assert theirs["step"] == ours["step"] == S
    assert set(ours["metrics"]) == set(theirs["metrics"])
    for k, v in theirs["metrics"].items():
        assert ours["metrics"][k].shape == v.shape, k
    np.testing.assert_allclose(ours["metrics"]["loss"], theirs["metrics"]["loss"], rtol=1e-4)


def test_scan_driver_parameters_match_jax():
    theirs, ours, flat = _jax_vs_port()
    keys = sorted(k for k in theirs["state"] if k.startswith("params/"))
    diff = np.concatenate([np.abs(ours["state"][k] - theirs["state"][k]).ravel() for k in keys])
    assert diff.max() <= 2.5 * LR * S
    assert (diff > 0.1 * LR).mean() <= 0.1
    moved = np.concatenate([np.abs(theirs["state"][k] - flat[k]).ravel() for k in keys])
    assert (moved > 0.5 * LR).mean() > 0.8


# ---------------------------------------------------------------------------
# against S sequential calls of the port's step, bit for bit
# ---------------------------------------------------------------------------
def _snapshot(states):
    out = {}
    for i, st in enumerate(states):
        for name, t in [*st.model.named_parameters(), *st.model.named_buffers()]:
            out[f"{i}/{name}"] = t.detach().clone()
        for j, per_param in enumerate(st.optimizer.state.values()):
            out.update({f"{i}/adam{j}/{k}": v.clone() for k, v in per_param.items()})
        out[f"{i}/step"] = torch.as_tensor(st.step).clone()
    return out


def _supervised():
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    return (TrainState(model, adam(LR)),
            steps.make_supervised_train_step(model, CLASSES, aug_cfg=PCFG),
            (_images(3), _masks(4)))


def _adversarial():
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    disc = create_discriminator(dtype=torch.float32, device="cpu")
    return (AdversarialState(TrainState(seg, adam(LR)), TrainState(disc, adam(LR))),
            steps.make_adversarial_train_step(seg, disc, CLASSES, aug_cfg=PCFG),
            (_images(5), _masks(6), _images(7)))


def _unsupervised():
    seg = create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu",
                      remat="encoder")
    disc = create_discriminator(dtype=torch.float32, device="cpu")
    state = TrainState(DomainAdaptationModel(seg, disc), adam(LR, clip_norm=1.0),
                       skip_nonfinite=True)
    step = steps.make_unsupervised_sequential_step(
        seg, disc, CLASSES, losses.FineTuningLoss(), aug_cfg=PCFG, carry_dtype=torch.bfloat16)
    return state, step, (_images(8), np.asarray(EPOCHS, np.float32))


def _grl():
    model = create_uda_model("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu")
    return (TrainState(model, adam(LR)),
            steps.make_grl_sequential_step(model, CLASSES, aug_cfg=PCFG),
            (_images(9), _masks(10), _images(11), np.asarray(ALPHAS, np.float32)))


FACTORIES = {"supervised": _supervised, "adversarial": _adversarial,
             "unsupervised": _unsupervised, "grl": _grl}
# the per-step arguments the sequential calls take as Python numbers
SCALAR_ARGS = {"unsupervised": (1,), "grl": (3,)}


@functools.cache
def _runs(case):
    """(sequential metrics stacked, their final snapshot, the scan driver's
    metrics, its final snapshot, the step counters of the scan driver's state)."""
    state, step, batches = FACTORIES[case]()
    gen = torch.Generator().manual_seed(21)
    per_step = []
    for i in range(S):
        args = [float(b[i]) if j in SCALAR_ARGS.get(case, ()) else b[i]
                for j, b in enumerate(batches)]
        state, metrics = step(state, gen, *args)
        per_step.append(metrics)
    seq = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
    seq_state = _snapshot(steps._train_states(state))

    state, step, batches = FACTORIES[case]()
    multi = steps.make_scan_driver(step)
    state, drv = multi(state, torch.Generator().manual_seed(21), *batches)
    return seq, seq_state, drv, _snapshot(steps._train_states(state)), [
        int(st.step) for st in steps._train_states(state)]


@pytest.mark.parametrize("case", list(FACTORIES))
def test_scan_driver_is_the_sequential_steps_bit_for_bit(case):
    seq, seq_state, drv, drv_state, counters = _runs(case)
    assert set(drv) == set(seq)
    for k, v in seq.items():
        assert drv[k].dtype == v.dtype and torch.equal(drv[k], v), k
    assert set(drv_state) == set(seq_state)
    for k, v in seq_state.items():
        assert torch.equal(drv_state[k], v), k
    assert counters == [S] * len(counters)


@pytest.mark.parametrize("case", list(FACTORIES))
def test_scan_driver_stacks_the_metrics(case):
    drv = _runs(case)[2]
    for k, v in drv.items():
        assert v.shape[0] == S, (k, v.shape)
    assert drv["loss" if "loss" in drv else "total"].shape == (S,)
    if "hist" in drv:
        assert drv["hist"].shape == (S, CLASSES, CLASSES)
        assert (drv["hist"].sum((1, 2)) == BATCH * SIZE * SIZE).all()
    if case == "unsupervised":
        expected = np.clip(np.float32(EPOCHS) / np.float32(40), 0, 1)
        np.testing.assert_array_equal(drv["rampup_weight"].numpy(), expected)


def test_scan_driver_refuses_ragged_and_scalar_arguments():
    state, step, (images, masks) = _supervised()
    multi = steps.make_scan_driver(step)
    with pytest.raises(ValueError, match="leading axes"):
        multi(state, None, images, masks[:2])
    seg, disc = (create_unet("resnet18", classes=CLASSES, dtype=torch.float32, device="cpu"),
                 create_discriminator(dtype=torch.float32, device="cpu"))
    unsup = steps.make_scan_driver(steps.make_unsupervised_train_step(
        seg, disc, CLASSES, losses.FineTuningLoss(), aug_cfg=PCFG))
    state = TrainState(DomainAdaptationModel(seg, disc), adam(LR), skip_nonfinite=True)
    for scalar in (20.0, 20, np.float32(20.0)):
        with pytest.raises(TypeError, match=r"\(S,\)"):
            unsup(state, None, images, scalar)
    with pytest.raises(ValueError, match="unroll"):
        steps.make_scan_driver(step, unroll=0)
    with pytest.raises(ValueError, match="capturable"):
        TrainState(seg, adam(LR), capturable=True)
    assert int(state.step) == 0                   # nothing ran


def test_rampup_of_a_tensor_is_the_host_rampup_bit_for_bit():
    for length in (40, 7, 3):
        ftl = losses.FineTuningLoss(rampup_length=length)
        for e in np.concatenate([np.arange(-2, 60, 0.37, dtype=np.float32), [0, length]]):
            host = ftl.rampup(float(e))
            for epoch in (torch.tensor(e), torch.tensor(float(e), dtype=torch.float64),
                          torch.tensor(int(e)) if float(e).is_integer() else torch.tensor(e)):
                dev = ftl.rampup(epoch)
                assert dev.dtype == torch.float32 and dev.shape == ()
                assert dev.view(torch.int32).item() == host.view(torch.int32).item(), (length, e)


# ---------------------------------------------------------------------------
# Adam's arithmetic
# ---------------------------------------------------------------------------
ADAM_LR = 1e-2


def _adam_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _numpy_adam(params, grad_trees, clip):
    """``optax.chain(clip_by_global_norm(clip), adam(ADAM_LR))`` (no clip for
    ``None``) over the gradient trees, in float64."""
    p = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v2 = {k: np.zeros_like(v) for k, v in p.items()}
    for t, grads in enumerate(grad_trees, 1):
        g = {k: x.astype(np.float64) for k, x in grads.items()}
        norm = np.sqrt(sum((x * x).sum() for x in g.values()))
        if clip is not None and norm >= clip:
            g = {k: x / norm * clip for k, x in g.items()}
        for k in p:
            m[k] = 0.9 * m[k] + 0.1 * g[k]
            v2[k] = 0.999 * v2[k] + 0.001 * g[k] * g[k]
            p[k] -= ADAM_LR * (m[k] / (1 - 0.9 ** t)) / (np.sqrt(v2[k] / (1 - 0.999 ** t))
                                                         + 1e-8)
    return p


@pytest.mark.parametrize("clip", [None, 0.5])
def test_numpy_adam_is_optax_adam(clip):
    import jax.numpy as jnp
    import optax

    from uda_aerial_semantic_segmentation_research_tpu.training import state as jax_state

    params = _adam_tree(1)
    grad_trees = [_adam_tree(10 + i) for i in range(3)]
    tx = jax_state.adam(ADAM_LR, clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    for grads in grad_trees:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert clip is None or np.sqrt(sum((g * g).sum() for g in grad_trees[0].values())) > clip
    for k, v in _numpy_adam(params, grad_trees, clip).items():
        np.testing.assert_allclose(np.asarray(jparams[k]), v, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("skip_nonfinite", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_capturable_adam_matches_optax_arithmetic_on_gpu(clip, skip_nonfinite):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = _adam_tree(1)
    grad_trees = [_adam_tree(10 + i) for i in range(3)]

    class Leaves(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = Leaves().cuda()
    state = TrainState(model, adam(ADAM_LR, clip), skip_nonfinite=skip_nonfinite,
                       capturable=True)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    for grads in grad_trees:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy()).cuda()
        state.apply_gradients(finite if skip_nonfinite else None)
    assert isinstance(state.step, torch.Tensor) and int(state.step) == 3
    for k, v in _numpy_adam(params, grad_trees, clip).items():
        np.testing.assert_allclose(getattr(model, k).detach().cpu().numpy(), v,
                                   rtol=1e-6, atol=1e-6)
    if skip_nonfinite:                  # a dropped update leaves the state as it was
        before = [p.detach().clone() for p in model.parameters()]
        state.apply_gradients(~finite)
        assert int(state.step) == 3
        assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))


# ---------------------------------------------------------------------------
# the kernels' capture guards, with the capture simulated
# ---------------------------------------------------------------------------
@pytest.fixture
def capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def test_wrappers_refuse_their_set_up_during_a_capture(capturing):
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="scratch.*capture"):
        channel_sums._scratch_for(cpu, 12345, 16)
    key = (cpu.index, 54321)
    channel_sums._scratch[key] = torch.zeros(1 << 16)
    try:
        assert channel_sums._scratch_for(cpu, 54321, 1 << 10) is channel_sums._scratch[key]
        with pytest.raises(RuntimeError, match="growing.*capture"):
            channel_sums._scratch_for(cpu, 54321, 1 << 17)
    finally:
        del channel_sums._scratch[key]
    with pytest.raises(RuntimeError, match="occupancy.*capture"):
        channel_sums._device_limits(97, 1, -1)
    with pytest.raises(RuntimeError, match="capture"):
        dihedral._device_sms(97)
    with pytest.raises(RuntimeError, match="imagenet_stats.*capture"):
        dihedral.imagenet_stats(torch.device("cuda", 97))
    with pytest.raises(RuntimeError, match="capture"):
        conv_bn_relu._bf16_blocks(None, 97, 1, 8, 8, 16, 16)
    with pytest.raises(RuntimeError, match="library.*capture"):
        _build.load_library("fused_cross_entropy")
    # the CPU constants are no capture's business
    dihedral.imagenet_stats(torch.device("cpu"))


def test_a_grown_scratch_keeps_its_predecessor_alive():
    cpu = torch.device("cpu")
    key = (cpu.index, 777)
    try:
        small = channel_sums._scratch_for(cpu, 777, 16)
        big = channel_sums._scratch_for(cpu, 777, (1 << 16) + 1)
        assert big is not small and any(t is small for t in channel_sums._retired)
    finally:
        channel_sums._scratch.pop(key, None)
        channel_sums._retired[:] = [t for t in channel_sums._retired if t.device != cpu]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_case():
    model = create_unet("resnet18", classes=CLASSES, dtype=torch.bfloat16, device="cuda")
    state = TrainState(model, adam(1e-4), capturable=True)
    step = steps.make_supervised_train_step(model, CLASSES, fused_ce=True)      # WEAK
    return model, state, step


def _card_batches(n):
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.integers(0, 256, (n, 4, 64, 64, 3), dtype=np.uint8)).cuda(),
            torch.from_numpy(rng.integers(0, CLASSES, (n, 4, 64, 64)).astype(np.uint8)).cuda())


@pytest.fixture
def deterministic_cudnn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.gpu
@pytest.mark.parametrize("unroll", [1, 2])
def test_cuda_graph_replays_are_the_eager_steps_on_gpu(deterministic_cudnn, unroll):
    images, masks = _card_batches(4)
    model, state, step = _card_case()
    gen = torch.Generator(device="cuda").manual_seed(3)
    eager = []
    for i in range(4):
        eager.append(step(state, gen, images[i], masks[i])[1]["loss"])
    eager_state = _snapshot([state])

    model, state, step = _card_case()
    multi = steps.make_scan_driver(step, unroll=unroll)
    gen = torch.Generator(device="cuda").manual_seed(3)
    state, first = multi(state, gen, images[:2], masks[:2])     # warm-up, capture, replays
    state, second = multi(state, gen, images[2:], masks[2:])    # replays of the same graph
    assert len(multi.graphs) == 1 and int(state.step) == 4
    assert torch.equal(torch.cat([first["loss"], second["loss"]]), torch.stack(eager))
    for k, v in eager_state.items():
        assert torch.equal(_snapshot([state])[k], v), k
    # the metrics are copies: another replay leaves them as they were
    kept = first["loss"].clone()
    multi(state, gen, images[:2], masks[:2])
    assert torch.equal(first["loss"], kept)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_scan_driver_under_a_process_group_on_gpu(deterministic_cudnn, tmp_path, backend):
    """Under an NCCL group of one process the graph holds the step's
    collectives and its replays are the eager steps bit for bit; under gloo,
    which stages CUDA tensors through the host, the card refuses."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed
    images, masks = _card_batches(2)
    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cuda",
                           backend=backend)
    try:
        model, state, step = _card_case()
        multi = steps.make_scan_driver(step)
        if backend == "gloo":
            with pytest.raises(RuntimeError, match="NCCL"):
                multi(state, torch.Generator(device="cuda").manual_seed(3), images, masks)
            return
        gen = torch.Generator(device="cuda").manual_seed(3)
        eager = [step(state, gen, images[i], masks[i])[1]["loss"] for i in range(2)]
        eager_state = _snapshot([state])
        model, state, step = _card_case()
        multi = steps.make_scan_driver(step)
        distributed.all_reduce_.counts.clear()
        state, metrics = multi(state, torch.Generator(device="cuda").manual_seed(3), images,
                               masks)
        assert distributed.all_reduce_.counts["bn_forward"][0] > 0
        assert torch.equal(metrics["loss"], torch.stack(eager))
        for k, v in eager_state.items():
            assert torch.equal(_snapshot([state])[k], v), k
    finally:
        distributed.shutdown()


@pytest.mark.gpu
def test_cuda_graph_scan_driver_refusals_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    images, masks = _card_batches(2)
    model, state, step = _card_case()
    multi = steps.make_scan_driver(step, unroll=2)
    with pytest.raises(ValueError, match="generator"):
        multi(state, torch.Generator(), images, masks)
    with pytest.raises(ValueError, match="capturable"):
        multi(TrainState(model, adam(1e-4)), None, images, masks)
    with pytest.raises(ValueError, match="unroll"):
        multi(state, None, images[:1], masks[:1])
    # channel_sums' scratch of a stream that never ran it cannot be made in a capture
    graph = torch.cuda.CUDAGraph()
    x = torch.ones(4, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
    channel_sums.channel_sums(x)            # the queries cached, this stream's scratch made
    with pytest.raises(RuntimeError, match="scratch.*capture"):
        with torch.cuda.graph(graph):
            channel_sums.channel_sums(x)
