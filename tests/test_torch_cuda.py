"""The CUDA kernels against their plain versions on the card. Marked
``cuda``: they skip where there is no GPU (run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -o addopts="" --noconftest``,
since the JAX test conftest and the xdist options are not for that machine)."""

import pytest
import torch

from gluefactory_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.float16, 2e-3),
                                        (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(1, 4, 512, 512), (2, 4, 100, 70)])
def test_kernels_match_plain(device, dtype, atol, shape):
    b, h, nq, nk = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, h, nq, 64, generator=g, device=device).to(dtype)
    k = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    v = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    mask = torch.rand(b, nk, generator=g, device=device) > 0.2
    if b > 1:
        mask[-1] = False  # a fully-masked batch item
    before = dict(A.launches)
    out = A.attention_cuda(q, k, v, mask)
    torch.testing.assert_close(out.float(), A.attention_plain(q, k, v, mask).float(),
                               atol=atol, rtol=atol)
    theta = torch.randn(b, nk, 32, generator=g, device=device)
    cos = theta.cos().repeat_interleave(2, -1).to(dtype)
    sin = theta.sin().repeat_interleave(2, -1).to(dtype)
    k, v = k[:, :, :nk], v[:, :, :nk]
    q = torch.randn(b, h, nk, 64, generator=g, device=device).to(dtype)
    out = A.attention_rotary_cuda(q, k, v, cos, sin, mask)
    torch.testing.assert_close(
        out.float(), A.attention_rotary_plain(q, k, v, cos, sin, mask).float(),
        atol=atol, rtol=atol)
    assert A.launches["attention"] == before["attention"] + 1
    assert A.launches["attention_rotary"] == before["attention_rotary"] + 1


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0),
                                             (torch.bfloat16, 8e-3, 8e-3)])
def test_kernels_match_plain_at_the_training_shape(device, dtype, atol, rtol):
    """32x4x512x64: one block walks all keys (see TOLERANCES in chip_smoke.py)."""
    import chip_smoke

    assert A._plan_for(torch.empty(32, 4, 512, 64, device=device), 512).splits == 1
    g = torch.Generator(device=device).manual_seed(3)
    for kernel, plain, rotary in ((A.attention_cuda, A.attention_plain, False),
                                  (A.attention_rotary_cuda, A.attention_rotary_plain, True)):
        args = chip_smoke._attention_inputs(32, 4, 512, 512, 64, dtype, rotary, g, device)
        out, ref = kernel(*args).float(), plain(*args).float()
        assert bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
        assert float(out[1].abs().max()) == 0.0  # the fully-masked item


@pytest.mark.parametrize("shape", [(1, 4, 512, 512), (1, 4, 200, 3000), (2, 4, 300, 300)])
def test_split_plans_match_plain_and_one_split(device, shape):
    """Shapes that take the split-key plan (partial states merged by a second
    kernel) against the plain version and against the one-split layout."""
    import chip_smoke

    b, h, nq, nk = shape
    plan = A._plan_for(torch.empty(b, h, nq, 64, device=device), nk)
    assert plan.splits > 1
    whole = A.AttentionPlan(64, -(-nk // A.KEY_TILE), 1)
    g = torch.Generator(device=device).manual_seed(4)
    q, k, v, mask = chip_smoke._attention_inputs(b, h, nq, nk, 64, torch.float32, False, g,
                                                 device)
    out = A.attention_cuda(q, k, v, mask)
    torch.testing.assert_close(out, A.attention_plain(q, k, v, mask), atol=2e-5, rtol=0)
    torch.testing.assert_close(out, A._launch_attention(q, k, v, mask, whole),
                               atol=2e-6, rtol=0)
    with pytest.raises(RuntimeError, match="error -1"):  # a plan that misses keys
        A._launch_attention(q, k, v, mask, plan._replace(splits=plan.splits - 1))


def test_wrappers_raise_on_what_the_kernel_does_not_take(device):
    q = torch.randn(1, 4, 64, 64, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        A.attention_cuda(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        A.attention_cuda(q[..., :32].contiguous(), q[..., :32].contiguous(),
                         q[..., :32].contiguous())
    with pytest.raises(TypeError):
        A.attention_cuda(q.double(), q.double(), q.double())
    buf = torch.randn(q.numel() + 1, device=device)
    with pytest.raises(ValueError, match="16-byte"):
        A.attention_cuda(buf[1:].view(q.shape), q, q)


def test_add_kernel_is_bit_exact(device):
    from gluefactory_torch.ops import elementwise as E

    g = torch.Generator(device=device).manual_seed(1)
    buf = torch.randn(2 * 65539 + 1, generator=g, device=device)
    before = E.launches["add"]
    cases = [(buf[:65536].view(256, 256), buf[65536:131072].view(256, 256)),
             (buf[:65539], buf[65539:131078]),  # a tail of 3
             (buf[1:65540], buf[65540:131079]),  # pointers not 16-byte aligned
             (buf[:3], buf[3:6])]
    for x, y in cases:
        assert torch.equal(E.add_cuda(x, y), x + y)
    assert E.launches["add"] == before + len(cases)
    with pytest.raises(ValueError, match="contiguous"):
        E.add_cuda(cases[0][0].t(), cases[0][1])
    with pytest.raises(TypeError):
        E.add_cuda(cases[0][0].double(), cases[0][1].double())
    with pytest.raises(ValueError, match="shapes"):
        E.add_cuda(cases[0][0], cases[1][1])
    E.launch_empty(buf.device)  # the launch floor of phase 5: launches, counts nothing
    torch.cuda.synchronize()
    assert E.launches["add"] == before + len(cases)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 1e-2, 2e-2)])
def test_kernel_gradients_match_plain_autograd(device, dtype, atol, rtol):
    """Autograd through the kernels' Functions against autograd through the
    plain versions (see GRAD_TOLERANCES in chip_smoke.py)."""
    g = torch.Generator(device=device).manual_seed(2)
    b, h, n = 2, 4, 300
    q, k, v, cot = (torch.randn(b, h, n, 64, generator=g, device=device).to(dtype)
                    for _ in range(4))
    theta = torch.randn(b, n, 32, generator=g, device=device) * 3
    cos = theta.cos().repeat_interleave(2, -1).to(dtype)
    sin = theta.sin().repeat_interleave(2, -1).to(dtype)
    mask = torch.rand(b, n, generator=g, device=device) > 0.2
    for fn, inputs in ((A.self_attention_rotary, (q, k, v, cos, sin)), (A.attention, (q, k, v))):
        grads = {}
        for impl in ("auto", "xla"):
            leaves = [t.clone().requires_grad_(True) for t in inputs]
            fn(*leaves, kv_mask=mask, implementation=impl).backward(cot)
            grads[impl] = [t.grad.float() for t in leaves]
        for a, ref in zip(grads["auto"], grads["xla"]):
            assert float((a - ref).abs().max()) <= atol + rtol * float(ref.abs().max())
    x = q.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Functions"):
        A.attention_cuda(x, k, v)


def test_tiny_training_step_on_the_card(device):
    """One step of the tiny flagship pipeline, LightGlue widened to the
    kernels' head dim, through the kernels."""
    import __graft_entry__
    from gluefactory_torch.train import Trainer

    conf = {"data": {"name": "homographies_ondevice", "pool_size": 2, "source_size": [96, 96],
                     "image_size": 64, "max_gt_points": 48, "train_batch_size": 2},
            "model": __graft_entry__._flagship_conf(tiny=True), "train": {"lr": 1e-3}}
    # the kernels take head dim 64 only: 128-d descriptors over 2 heads
    conf["model"]["matcher"].update(attention="auto", descriptor_dim=128)
    trainer = Trainer(conf, device=device)
    A.reset_launches()
    scalars = trainer.step(0)
    assert A.launches == {"attention_rotary": 4, "attention": 4}
    assert scalars["skipped"] == 0.0 and scalars["grad_norm"] > 0


def test_bundle_adjust_graph_matches_eager_loop(device):
    """The BA's replayed CUDA graph of one LM iteration against the eager
    loop of the same iterations on the card, in float64 on a small arc of 4
    cameras around 60 points: the same steps, costs within 1e-9 of the
    largest, poses within 1e-9."""
    from gluefactory_torch.geometry.utils import so3exp_map
    from gluefactory_torch.geometry.wrappers import Camera, Pose
    from gluefactory_torch.sfm.ba import BAProblem, _observed_cameras, bundle_adjust, lm_step

    g = torch.Generator().manual_seed(0)
    M, P = 4, 60
    points = torch.rand(P, 3, generator=g, dtype=torch.float64) * 2 - 1
    angles = torch.linspace(-0.3, 0.3, M, dtype=torch.float64)
    R = so3exp_map(torch.stack([torch.zeros(M), angles, torch.zeros(M)], -1).double())
    t = torch.tensor([0.0, 0.0, 5.0], dtype=torch.float64).expand(M, 3).clone()
    cams = Camera.from_fc([[640.0, 480.0]] * M, [[500.0, 500.0]] * M, [[320.0, 240.0]] * M)
    cams = cams.to(dtype=torch.float64)
    obs_cam = torch.arange(M).repeat_interleave(P)
    obs_pt = torch.arange(P).repeat(M)
    uv, valid = cams.cam2image(Pose(R, t).transform(points[None].expand(M, P, 3)))
    uv = uv.reshape(-1, 2) + 0.5 * torch.randn(M * P, 2, generator=g, dtype=torch.float64)
    fixed = torch.zeros(M, dtype=torch.bool)
    fixed[0] = True
    noisy = Pose(R, t).retract_left(0.01 * torch.randn(M, 6, generator=g, dtype=torch.float64))
    problem = BAProblem(noisy, cams, points + 0.05 * torch.randn(P, 3, generator=g,
                                                                   dtype=torch.float64),
                        obs_cam, obs_pt, uv, valid.reshape(-1), fixed).to(device)
    poses, _, info = bundle_adjust(problem, num_iters=15, huber_delta=1.0, trim_th=20.0)
    e_poses, e_points, lam = problem.poses, problem.points, torch.tensor(
        1e-3, dtype=torch.float64, device=device)
    costs, accepted = [], []
    for _ in range(15):
        e_poses, e_points, lam, cost, accept = lm_step(problem, e_poses, e_points, lam, 1.0,
                                                       20.0, _observed_cameras(problem))
        costs.append(cost)
        accepted.append(accept)
    assert torch.equal(info["accepted"], torch.stack(accepted))
    costs = torch.stack(costs)
    assert (info["costs"] - costs).abs().max() <= 1e-9 * costs.abs().max()
    assert (poses.R - e_poses.R).abs().max() <= 1e-9 and (poses.t - e_poses.t).abs().max() <= 1e-9
    assert info["costs"][-1] < info["costs"][0]
