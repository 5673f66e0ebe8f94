"""smp's DeepLabV3+ in the port (``DeepLabV3Plus(layout="smp")``, the
output-stride-16 ResNet encoder, the seeded ``Dropout``) against the plain
reference of the benchmark (``port_bench/reference/deeplabv3plus.py``,
float32 torch that imports nothing of the port), on the CPU in float32 at
64 px, B=2, on seeded random weights made for both sides by
``port_bench.inputs.make_weights``.

Tolerances, and why:
- eval logits: 1e-5 of the largest |logit| (measured 1.4e-6): the same
  float32 operations, summed in another order (the port's BatchNorm
  normalizes with ``rsqrt(var + eps) * scale`` folded, the reference with
  ``F.batch_norm``);
- train-mode logits: 1e-3 of the largest (measured 1.0e-4): a train-mode
  BatchNorm at B=2 normalizes few values a channel (the ASPP's pooled one
  two), which amplifies float32 noise, and the port's batch variance is
  ``E[x^2] - mean^2`` (the flax formula) where the reference's is
  two-pass;
- the loss: 1e-5 relative (measured 1e-6);
- gradient norms: ``check.training_numbers``'s ``grad_gap`` (each leaf's
  gap against the larger of its norm and the median leaf's) under 1e-2
  (measured 2.7e-3, at a stage-1 BatchNorm scale, for the same reasons);
- the first step's BatchNorm statistics: ``stats_gap`` under 1e-3
  (measured 5.9e-5);
- the dropout's masks: exact (the same generator, seed and draws).
"""

import json
from pathlib import Path

import pytest
import torch

from port_bench import check, inputs
from port_bench.kinds.train_epoch import batch_statistics
from port_bench.reference import deeplabv3plus as ref
from port_bench.reference import train as ref_train
from port_bench.reference import trainable
from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_model
from uda_aerial_semantic_segmentation_research_tpu_torch.models.architectures import (
    DeepLabV3Plus,
    Dropout,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    ResNetEncoder,
    build_encoder,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    softmax_cross_entropy,
)

CONFIG = Path(__file__).resolve().parents[1] / "port_bench" / "configs" / \
    "deeplabv3plus_resnet101.json"
SIZE, BATCH, CLASSES, DROPOUT_SEED = 64, 2, 7, 2 ** 31 + 9
ENCODERS = {"resnet18": ("basic", [2, 2, 2, 2]), "resnet101": ("bottleneck", [3, 4, 23, 3])}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads, as the other port test files take them: the
    tier-1 run has six workers on eight cores.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(encoder):
    block, sizes = ENCODERS[encoder]
    return dict(json.loads(CONFIG.read_text()), encoder_name=encoder, block=block,
                stage_sizes=sizes, classes=CLASSES, dropout_seed=DROPOUT_SEED)


def both(encoder, seed):
    """The port's model and the reference's parameters, on one seed's weights."""
    cfg = config(encoder)
    weights = inputs.make_weights(ref.weight_spec(cfg), seed, "cpu")
    model = create_model("DeepLabV3Plus", encoder, classes=CLASSES, layout="smp",
                         seed=DROPOUT_SEED, dtype=torch.float32, device="cpu")
    model.load_state_dict(weights)
    return cfg, weights, model


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_forward_and_one_train_step_match_the_reference(encoder):
    cfg, weights, model = both(encoder, 2 ** 31 + 41)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(BATCH, SIZE, SIZE, 3, generator=g)
    labels = torch.randint(0, CLASSES, (BATCH, SIZE, SIZE), generator=g)

    with torch.no_grad():
        ours, theirs = model(x), ref.Net(cfg, weights, train=False)(x)
    assert ours.shape == (BATCH, SIZE, SIZE, CLASSES) and ours.dtype == torch.float32
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-5 * float(theirs.abs().max()))

    model.train()
    logits = model(x)
    loss = softmax_cross_entropy(logits, labels)
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items() if trainable(k)}
    stats = {}
    r_logits = ref.Net(cfg, {**weights, **params}, train=True, stats=stats)(x)
    r_loss = ref_train.cross_entropy(r_logits, labels)
    r_grads = torch.autograd.grad(r_loss, list(params.values()))
    torch.testing.assert_close(logits.detach(), r_logits.detach(), rtol=0,
                               atol=1e-3 * float(r_logits.detach().abs().max()))
    assert abs(float(loss.detach()) - float(r_loss.detach())) <= 1e-5 * abs(float(r_loss.detach()))
    grads = {k: float(p.grad.norm()) for k, p in model.named_parameters()}
    r_norms = {k: float(v.norm()) for k, v in zip(params, r_grads)}
    assert set(grads) == set(r_norms)
    assert check._norm_gap(grads, r_norms, r_norms) < 1e-2
    assert check._stats_gap(batch_statistics(model, weights), stats) < 1e-3


def test_dropout_masks_are_the_references_and_eval_draws_none():
    cfg, weights, model = both("resnet18", 2 ** 31 + 43)
    seen = []
    model.aspp_dropout.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].detach(), out.detach())))
    x = torch.randn(BATCH, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(6))
    net = ref.Net(cfg, weights, train=True)
    model.train()
    with torch.no_grad():
        for k in range(2):
            ours, theirs = model(x), net(x)
            assert net.k == k == model.aspp_dropout.draws - 1
            torch.testing.assert_close(ours, theirs, rtol=0,
                                       atol=1e-3 * float(theirs.abs().max()))
    # the program's two masks, each against the reference's dropout of the same input
    for k, (before, after) in enumerate(seen):
        net.k = k
        assert torch.equal(after, net.dropout(before))
    mask0 = ref.Net(cfg, weights, train=True)
    mask0.k = 0
    ones = torch.ones(seen[0][0].shape)
    kept = [mask0.dropout(ones)]
    mask0.k = 1
    kept.append(mask0.dropout(ones))
    assert set(kept[0].unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((kept[0] > 0).float().mean()) < 0.55
    assert not torch.equal(kept[0], kept[1])             # a new mask each forward

    model.eval()
    net_eval = ref.Net(cfg, weights, train=False)
    with torch.no_grad():
        model(x), net_eval(x)
    assert model.aspp_dropout.draws == 2 and len(seen) == 3
    assert torch.equal(seen[2][0], seen[2][1])            # eval: the input as it is
    assert ref._DRAWS[id(weights["head.weight"])] == 2   # the reference drew none either
    model.seed_dropout(DROPOUT_SEED)                      # restarts the masks
    assert model.aspp_dropout.draws == 0


def test_dropout_keeps_no_generator_and_deepcopies():
    import copy

    drop = Dropout(0.5, seed=3).train()
    x = torch.ones(2, 4, 3, 3)
    first = drop(x)
    twin = copy.deepcopy(drop)
    assert torch.equal(drop(x), twin(x)) and not torch.equal(first, drop(x))
    assert dict(drop.state_dict()) == {} and not any(
        isinstance(v, torch.Generator) for v in vars(drop).values())


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_output_stride_16_dilates_stage_4(name):
    torch.manual_seed(0)
    plain = build_encoder(name, dtype=torch.float32)
    same = build_encoder(name, dtype=torch.float32, output_stride=32)
    dilated = build_encoder(name, dtype=torch.float32, output_stride=16)
    same.load_state_dict(plain.state_dict())
    dilated.load_state_dict(plain.state_dict())       # the same parameters
    x = torch.randn(1, SIZE, SIZE, 3)
    with torch.no_grad():
        base, again, dil = plain(x), same(x), dilated(x)
    # 32: today's pyramid, bit for bit
    assert [f.shape[1:3] for f in base] == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4),
                                            (2, 2)]
    assert all(torch.equal(a, b) for a, b in zip(base, again))
    # 16: the last two levels at /16, everything before them unchanged
    assert [f.shape[1:3] for f in dil][4:] == [(4, 4), (4, 4)]
    assert all(torch.equal(a, b) for a, b in zip(base[:5], dil[:5]))
    for (n, conv), (_, conv32) in zip(dilated.named_modules(), plain.named_modules()):
        if n.startswith("stage4_") and isinstance(conv, torch.nn.Conv2d):
            k = conv.kernel_size[0]
            assert conv.stride == (1, 1)
            assert conv.dilation == ((2, 2) if k == 3 else (1, 1))
            assert conv.padding == ((2, 2) if k == 3 else (0, 0))
        elif isinstance(conv, torch.nn.Conv2d):
            assert (conv.stride, conv.dilation, conv.padding) == (
                conv32.stride, conv32.dilation, conv32.padding)


@pytest.mark.parametrize("stride", [8, 24, 64, 0])
def test_other_output_strides_raise(stride):
    with pytest.raises(ValueError, match="output_stride"):
        build_encoder("resnet34", output_stride=stride)
    with pytest.raises(ValueError, match="output_stride"):
        ResNetEncoder((1, 1, 1, 1), type(build_encoder("resnet18").stage1_block0),
                      output_stride=stride)


def test_mobilenet_and_an_unknown_layout_raise():
    with pytest.raises(ValueError, match="output_stride"):
        build_encoder("mobilenet_v2", output_stride=16)
    with pytest.raises(ValueError, match="layout"):
        DeepLabV3Plus("resnet18", layout="torchvision")
