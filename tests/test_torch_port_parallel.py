"""The port's view parallelism against the JAX package, on the CPU.

The port's ranks are processes joined over gloo (``run_ranks``), fp32, each
with its block of the views; the rank bodies live in the port
(``tools/view_parallel_ranks.py``), so no rank process imports JAX. The JAX
side runs on the 8-device virtual mesh of conftest.py, with its einsum
backend; the port's ranks run the plain versions of their kernels. The
rendezvous is a file under each test's tmp_path, so parallel test workers do
not meet.

- ``ring_attention``, ``allgather_kv_attention`` and ``global_attention_cp``
  (both schedules, with and without the extra token) at 2 and 4 ranks:
  values, and the gradients of a fixed weighted sum of og and oe.
- The small model's view-sharded forward at 2 ranks under both schedules,
  against the JAX unsharded forward on the same weights.
- A group of one rank in this process (the card runs NCCL at world size 1):
  the ring's one step is plain attention and rotates nothing; the rules of
  the view group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.parallel import sharded_attention as jax_sa
from mapanything_tpu.parallel.mesh import make_mesh
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.ops.flash_attention import attention_reference
from mapanything_tpu_torch.parallel import sharded_attention as port_sa
from mapanything_tpu_torch.parallel.context import infer_view_sharded, max_views_per_chip_estimate
from mapanything_tpu_torch.parallel.distributed import init_distributed_mode, run_ranks
from mapanything_tpu_torch.parallel.mesh import ViewGroup, all_reduce, make_view_group, view_slice
from mapanything_tpu_torch.tools import view_parallel_ranks
from mapanything_tpu_torch.utils import threads


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)


ATTN_TOL = 1e-5  # of each output's magnitude; fp32 on both sides

# (fn, schedule, with the extra token)
CASES = [
    ("ring_attention", None, False),
    ("allgather_kv_attention", None, False),
    ("global_attention_cp", "ring", False),
    ("global_attention_cp", "ring", True),
    ("global_attention_cp", "allgather", False),
    ("global_attention_cp", "allgather", True),
]
B, T, H, D, E = 1, 512, 2, 64, 1  # 128 or 256 grid tokens a rank: the kernels' path, not the dense one
SCALE = 0.15


def case_inputs(seed):
    rng = np.random.RandomState(seed)
    mk = lambda t: rng.randn(B, t, H, D).astype(np.float32)  # noqa: E731
    return dict(q=mk(T), k=mk(T), v=mk(T), qe=mk(E), ke=mk(E), ve=mk(E), wg=mk(T), we=mk(E))


@pytest.fixture(scope="module")
def port_attention(tmp_path_factory):
    """Every case at 2 and at 4 ranks, one launch for each rank count."""
    cases = [dict(case_inputs(i), fn=fn, schedule=schedule, scale=SCALE) for i, (fn, schedule, _) in enumerate(CASES)]
    for case, (_, _, extra) in zip(cases, CASES):
        if not extra:
            case.update(qe=None, ke=None, ve=None)
    out = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"attention{n}") / "rendezvous"
        out[n] = run_ranks(view_parallel_ranks.attention_cases, n, "cpu", path, cases)[0]
    return out


def jax_attention(fn, schedule, extra, n, x):
    mesh = make_mesh(jax.devices()[:n], view_parallelism=n)
    names = ["q", "k", "v"] + (["qe", "ke", "ve"] if extra else [])
    args = [jnp.asarray(x[k]) for k in names]

    def outputs(*a):
        if fn == "ring_attention":
            return jax_sa.ring_attention(*a, mesh, scale=SCALE, backend="einsum"), None
        if fn == "allgather_kv_attention":
            return jax_sa.allgather_kv_attention(*a, mesh, scale=SCALE), None
        if not extra:
            a = list(a) + [None, None, None]
        return jax_sa.global_attention_cp(*a, mesh=mesh, scale=SCALE, schedule=schedule, backend="einsum")

    def weighted(*a):
        og, oe = outputs(*a)
        total = jnp.sum(og * x["wg"])
        return total + jnp.sum(oe * x["we"]) if oe is not None else total

    og, oe = jax.jit(outputs)(*args)
    grads = jax.jit(jax.grad(weighted, argnums=tuple(range(len(args)))))(*args)
    want = {"og": og, **{f"d{k}": g for k, g in zip(names, grads)}}
    if extra:
        want["oe"] = oe
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{f}-{s}-{'extra' if e else 'grid'}" for f, s, e in CASES])
def test_sharded_attention_matches_jax(port_attention, n, case, record_property):
    fn, schedule, extra = CASES[case]
    got = port_attention[n][case]
    want = jax_attention(fn, schedule, extra, n, case_inputs(case))
    assert sorted(got) == sorted(want)
    worst = 0.0
    for name, ref in want.items():
        err = float(np.abs(got[name] - ref).max()) / float(np.abs(ref).max())
        worst = max(worst, err)
        assert err <= ATTN_TOL, (name, err)
    record_property("err_over_magnitude", worst)


# ---------------------------------------------------------------- the small model


PRED_FIELDS = (
    "pts3d", "pts3d_cam", "ray_directions", "depth_along_ray", "cam_trans", "cam_quats",
    "metric_scaling_factor", "conf", "non_ambiguous_mask_logits",
)
V, HW = 4, 28
# (extra config, with geometric inputs): the default small model on images,
# and a narrower one (the "test" ViT, a trunk of width 64) with every
# geometric input, the non-reference-view PE and entropy scaling: global view
# indices and the global token count.
MODELS = {
    "images": ({}, False),
    "geometric-pe-entropy": (
        dict(encoder_size="test", info_sharing_dim=64, use_pe_for_non_reference_views=True,
             use_entropy_scaling=True),
        True,
    ),
}


def views_np(geometric, seed=5):
    rng = np.random.RandomState(seed)
    out = {"img": rng.randn(1, V, HW, HW, 3).astype(np.float32)}
    if geometric:
        dirs = rng.randn(1, V, HW, HW, 3).astype(np.float32)
        dirs[..., 2] = np.abs(dirs[..., 2]) + 0.5
        quats = rng.randn(1, V, 4).astype(np.float32)
        out.update(
            ray_directions=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
            depth_along_ray=rng.uniform(1, 5, (1, V, HW, HW, 1)).astype(np.float32),
            camera_pose_quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True),
            camera_pose_trans=rng.randn(1, V, 3).astype(np.float32),
            is_metric_scale=np.ones((1, V), bool),
        )
    return out


@pytest.fixture(scope="module")
def cp_forwards(tmp_path_factory):
    """Each model's JAX unsharded forward, and the port's 2-rank forwards under
    both schedules (one launch of the ranks for all)."""
    wants, models = {}, []
    for name, (config_kw, geometric) in MODELS.items():
        views = views_np(geometric)
        jviews = jax_ma.Views(**{k: jnp.asarray(v) for k, v in views.items()})
        model = jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**config_kw))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), jviews)
        wants[name] = jax.jit(model.apply)(variables, jviews)
        models.append((config_kw, jax.tree.map(np.asarray, variables["params"]), views))
    path = tmp_path_factory.mktemp("forward") / "rendezvous"
    gots = run_ranks(view_parallel_ranks.cp_forwards, 2, "cpu", path, models, ("allgather", "ring"))[0]
    return {name: (wants[name], got) for name, got in zip(MODELS, gots)}


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
@pytest.mark.parametrize("model", list(MODELS))
def test_small_cp_forward_matches_jax_unsharded(cp_forwards, model, schedule, record_property):
    want, got = cp_forwards[model]
    preds = got[schedule]
    worst = 0.0
    for name in PRED_FIELDS:
        r, o = np.asarray(getattr(want, name)), preds[name]
        assert o.shape == r.shape, name
        # fp32 both sides; errors relative to the field's magnitude, as in test_torch_port_model.py
        tol = 1e-4 * max(1.0, float(np.abs(r).max()))
        worst = max(worst, float(np.abs(o - r).max()) / max(1.0, float(np.abs(r).max())))
        np.testing.assert_allclose(o, r, atol=tol, rtol=0, err_msg=name)
    assert np.mean(np.asarray(want.non_ambiguous_mask) == preds["non_ambiguous_mask"]) >= 0.999
    record_property("err_over_magnitude", worst)


# ---------------------------------------------------------------- one rank, in this process


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone, as the card runs NCCL at world size 1."""
    info = init_distributed_mode("cpu", f"file://{tmp_path / 'rendezvous'}", 0, 1)
    try:
        yield info
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_ring_is_plain_attention_and_sends_nothing(one_rank_group):
    assert one_rank_group == {"world_size": 1, "rank": 0, "local_devices": 1, "distributed": False}
    group = make_view_group()
    x = {k: torch.from_numpy(v) for k, v in case_inputs(7).items()}
    port_sa.reset_counts()
    og, oe = port_sa.global_attention_cp(x["q"], x["k"], x["v"], x["qe"], x["ke"], x["ve"], group, SCALE, "ring")
    full = attention_reference(torch.cat([x["q"], x["qe"]], 1), torch.cat([x["k"], x["ke"]], 1),
                               torch.cat([x["v"], x["ve"]], 1), SCALE)
    torch.testing.assert_close(torch.cat([og, oe], 1), full, rtol=0, atol=1e-5)
    counts = port_sa.counts()
    # One ring step, no rotation; the extra queries' partials still meet in one all-gather.
    assert counts == {"ring_steps": 1, "ring_bwd_steps": 0, "collectives": {"all_gather": 1}}


def test_view_group_rules(one_rank_group):
    group = make_view_group()
    assert (group.rank, group.size, group.next_rank, group.prev_rank) == (0, 1, 0, 0)
    with pytest.raises(RuntimeError, match="cannot go through"):
        all_reduce(torch.zeros(2, device="meta"), group)  # only cuda (NCCL) or cpu (gloo) tensors
    with pytest.raises(ValueError, match="do not split"):
        view_slice(ViewGroup(rank=0, size=2, ranks=(0, 1)), 3)
    # The context alone shards the trunk: any model runs view-sharded, and at
    # one rank it is the unsharded forward.
    model = port_ma.MapAnything(port_ma.MapAnythingConfig.small(info_sharing_depth=2, info_sharing_indices=(0, 1)),
                                device="cpu")
    views = port_ma.Views(img=torch.from_numpy(np.random.RandomState(3).randn(1, 2, 28, 28, 3).astype(np.float32)))
    with torch.inference_mode():
        want = model(views)
    got = infer_view_sharded(model, views, group, "ring")
    for name in PRED_FIELDS:  # the tolerance of the small CP forward above
        r = getattr(want, name)
        torch.testing.assert_close(getattr(got, name), r, rtol=0, atol=1e-4 * max(1.0, float(r.abs().max())))


def test_single_process_needs_no_group(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    info = init_distributed_mode("cpu")
    assert info == {"world_size": 1, "rank": 0, "local_devices": 1, "distributed": False}
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_view_group()
    assert max_views_per_chip_estimate((518, 518)) == 70  # 0.6 · 80 GB over 680 MB a view
