"""The step-0 training gate of chip_smoke.py (phase 7) on the CPU: a
near-tie in an argmax flips a token-confidence target under a 1-ulp change,
the flip moves only the token_confidence heads' gradients, and the gate
holds those heads by the share of flipped targets and every other parameter
by its gradient."""

import numpy as np
import pytest
import torch

import chip_smoke
from gluefactory_torch.models.matchers.lightglue import LightGlue, confidence_targets

torch.set_num_threads(2)

CONF = {"input_dim": 32, "descriptor_dim": 32, "num_heads": 2, "n_layers": 3,
        "attention": "xla", "checkpointed": False, "save_layer_outputs": True}


def _data(seed=0, b=2, m=24, n=20):
    rng = np.random.default_rng(seed)
    data = {"keypoints0": rng.uniform(0, 64, (b, m, 2)), "keypoints1": rng.uniform(0, 64, (b, n, 2)),
            "descriptors0": rng.normal(size=(b, m, 32)), "descriptors1": rng.normal(size=(b, n, 32)),
            "keypoint_valid0": rng.uniform(size=(b, m)) > 0.1,
            "keypoint_valid1": rng.uniform(size=(b, n)) > 0.1,
            "gt_matches0": rng.integers(-2, n, (b, m)), "gt_matches1": rng.integers(-2, m, (b, n))}
    data = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in data.items()}
    data["view0"] = {"image_size": torch.full((b, 2), 64.0)}
    data["view1"] = {"image_size": torch.full((b, 2), 64.0)}
    return data


def _near_tie(pred, data, model, up: bool):
    """``pred`` with one final-layer score moved so that, in one row whose
    layer-0 argmax is its final argmax, another column sits one ulp below
    (up=False) or above (up=True) the maximum."""
    final = pred["log_assignment"].detach().clone()
    scores = model.log_assignment[0](pred["desc_layers0"][0], pred["desc_layers1"][0],
                                     data["keypoint_valid0"], data["keypoint_valid1"])[0]
    agree = (scores.argmax(2) == final.argmax(2)) & data["keypoint_valid0"]
    b, r = (int(i) for i in agree.nonzero()[0])
    j = int(final[b, r].argmax())
    c = (j + 1) % final.shape[2]
    top = final[b, r, j]
    final[b, r, c] = torch.nextafter(top, top + (1 if up else -1))
    return {**pred, "log_assignment": final}


def _loss_and_grads(model, pred, data):
    model.zero_grad(set_to_none=True)
    losses, _ = model.loss(pred, data)
    losses["total"].mean().backward(retain_graph=True)
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def test_confidence_targets_are_the_argmax_agreement():
    scores = torch.tensor([[[0.0, 2.0, 1.0], [3.0, 0.0, 1.0]]])
    final = torch.tensor([[[0.0, 2.0, 3.0], [3.0, 5.0, 0.0]]])
    rows, cols = confidence_targets(scores, final)
    assert rows.tolist() == [[False, False]] and cols.tolist() == [[True, False, True]]


def test_a_one_ulp_near_tie_flips_a_target_and_only_the_confidence_gradients():
    torch.manual_seed(0)
    model = LightGlue(CONF)
    data = _data()
    pred = model({k: v for k, v in data.items() if not k.startswith("gt_")})
    low, high = _near_tie(pred, data, model, up=False), _near_tie(pred, data, model, up=True)
    ctx = {**data}
    targets_low = model.layer_confidence_targets(low, ctx)
    targets_high = model.layer_confidence_targets(high, ctx)
    flips = sum(int((a != b).sum()) for a, b in zip(targets_low, targets_high))
    assert flips >= 1
    g_low, g_high = _loss_and_grads(model, low, data), _loss_and_grads(model, high, data)
    moved = {name for name in g_low if not torch.equal(g_low[name], g_high[name])}
    assert moved and all(name.startswith("token_confidence.") for name in moved), moved


def _reading(flips=0, n=100_000, conf_err=0.0, other_err=0.0):
    """(ref, run) as chip_smoke.step0 returns them, with ``flips`` targets
    flipped and gradients moved by the given shares of their largest."""
    ref_targets = [torch.zeros(n, dtype=torch.bool)]
    run_targets = [ref_targets[0].clone()]
    run_targets[0][:flips] = True
    grads = {"token_confidence.0.token.0.weight": torch.ones(4),
             "transformers.0.self_attn.Wqkv.weight": torch.ones(4)}
    moved = {"token_confidence.0.token.0.weight": torch.ones(4) + conf_err,
             "transformers.0.self_attn.Wqkv.weight": torch.ones(4) + other_err}
    return (1.0, grads, ref_targets, n), (1.0, moved, run_targets, n)


@pytest.mark.parametrize("flips,conf_err,other_err,passes", [
    (0, 0.0, 0.0, True),
    (100, 0.19, 0.005, True),  # 1e-3 of the targets, the heads moved: held by the share
    (101, 0.0, 0.0, False),  # just over the share
    (0, 0.0, 0.011, False),  # a gradient outside the heads over 1e-2
])
def test_step0_gate_holds_heads_by_flipped_share(flips, conf_err, other_err, passes):
    reading = chip_smoke.against(*_reading(flips, 100_000, conf_err, other_err))
    assert reading["flips"] == flips and reading["targets"] == 100_000
    assert reading["passes"] is passes
    assert reading["worst_param"] == "transformers.0.self_attn.Wqkv.weight"
    assert reading["confidence_worst"] == pytest.approx(conf_err)
