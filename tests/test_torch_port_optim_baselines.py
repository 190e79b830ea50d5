"""The optimisation-based baselines of the port against the JAX package's, on the CPU.

``global_align`` on 3 views of 24 x 32 (6 directed pairs of a noisy synthetic scene): the
MST initialisation (run with ``lr=0``, so the result is the initialisation) and 20 Adam
steps. The hand-written Adam and its schedules against optax on a toy objective. The
wrappers at ``size="small"`` with short loops, the same seeded weights on both sides
(the JAX tree's shapes from ``jax.eval_shape``, filled by ``seeded_params``):
``dust3r_ba``, ``pow3r_ba`` (with all three priors) and ``mast3r_sga``. The matchers:
``reciprocal_matches`` and ``predict_tracks_descriptors`` / ``tracks_from_descriptor_matcher``
with one descriptor function on both sides. The registry builds the five slots.

Tolerance: each float output within 1e-4 of max(1, its magnitude); the initialisation
within 1e-6 of it (numpy on both sides but for the Umeyama SVD, the quaternion of a
rotation, and exp and log), the initial poses and depths within 2e-5 (chained fp32
SVDs); indices and masks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapanything_tpu.ba import global_alignment as jax_ga
from mapanything_tpu.ba import tracker as jax_tracker
from mapanything_tpu.ba import tracks as jax_tracks
from mapanything_tpu.models.external import dust3r_ba as jax_dust3r_ba
from mapanything_tpu.models.external import mast3r as jax_mast3r
from mapanything_tpu.models.external import pow3r as jax_pow3r
from mapanything_tpu.models.modular_dust3r import ModularDUSt3RConfig as JaxDUSt3RConfig
from mapanything_tpu_torch.ba import global_alignment as port_ga
from mapanything_tpu_torch.ba import tracker as port_tracker
from mapanything_tpu_torch.ba import tracks as port_tracks
from mapanything_tpu_torch.models import external as port_external
from mapanything_tpu_torch.models.external import mast3r as port_mast3r
from mapanything_tpu_torch.models.registry import init_model
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_baselines import pow3r_inputs
from test_torch_port_infer import seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RTOL = 1e-4
INIT_RTOL = 1e-6
POSE_INIT_RTOL = 2e-5


def close(got, want, rtol=RTOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return 0.0
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=name)
    return float(np.abs(got - want).max()) / scale


def close_views(got, want, rtol=RTOL):
    assert len(got) == len(want)
    errs = []
    for v, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (set(g), set(w))
        errs += [close(g[k], np.asarray(w[k]), rtol, f"{k} of view {v}") for k in w]
    return max(errs)


def synthetic_graph(seed=0, V=3, H=24, W=32) -> dict:
    """Pair pointmaps of a scene seen by V cameras: each directed pair (i, j) holds view
    i's points and view j's, both in frame i, scaled by a per-pair factor, with noise;
    confidences in [1, 3)."""
    rng = np.random.RandomState(seed)
    depth = (2.0 + rng.rand(V, H, W)).astype(np.float32)
    v_, u_ = np.mgrid[:H, :W].astype(np.float32)
    cams = np.stack([(u_ - W / 2) * depth / 28.0, (v_ - H / 2) * depth / 28.0, depth], -1)  # (V, H, W, 3)
    c2w = np.tile(np.eye(4), (V, 1, 1))
    for v in range(1, V):
        a = 0.1 * v
        c2w[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[v, :3, 3] = [0.3 * v, 0.05, -0.1]
    world = np.einsum("vij,vhwj->vhwi", c2w[:, :3, :3], cams) + c2w[:, None, None, :3, 3]
    edges = jax_ga.make_complete_pairs(V)
    pts_i, pts_j = [], []
    for i, j in edges:
        w2c_i = np.linalg.inv(c2w[i])
        s = 0.8 + 0.4 * rng.rand()
        to_i = lambda x: s * (np.einsum("ij,hwj->hwi", w2c_i[:3, :3], x) + w2c_i[:3, 3])  # noqa: E731
        pts_i.append(to_i(world[i]) + 0.01 * rng.randn(H, W, 3))
        pts_j.append(to_i(world[j]) + 0.01 * rng.randn(H, W, 3))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(num_views=V, edges=edges, pts_i=f32(pts_i), pts_j=f32(pts_j),
                conf_i=f32(1 + 2 * rng.rand(len(edges), H, W)), conf_j=f32(1 + 2 * rng.rand(len(edges), H, W)))


def scene_fields(scene):
    return {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}


@pytest.mark.parametrize("niter,lr,rtol", [(1, 0.0, INIT_RTOL), (20, 0.01, RTOL)], ids=["init", "adam_20"])
def test_global_align_matches_jax(niter, lr, rtol, record_property):
    """With ``lr=0`` the result is the initialisation: focals to 1e-6, the poses and the
    depths (which take the poses' scale) to 2e-5: they come through chained fp32 Umeyama
    SVDs, whose rounding differs between LAPACK and XLA."""
    g = synthetic_graph()
    want = jax_ga.global_align(jax_ga.PairGraph(**g), niter=niter, lr=lr)
    got = port_ga.global_align(port_ga.PairGraph(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) and
                                                    v.dtype == np.float32 else v for k, v in g.items()}),
                               niter=niter, lr=lr)
    errs = {k: close(v, scene_fields(want)[k], max(rtol, POSE_INIT_RTOL) if k in ("cam2world", "depthmaps") else rtol, k)
            for k, v in scene_fields(got).items() if k != "loss"}
    np.testing.assert_allclose(got.loss, want.loss, rtol=max(rtol, POSE_INIT_RTOL))
    record_property("max_err_over_magnitude", max(errs.values()))


def test_spanning_tree_matches_jax_on_ties():
    edges = jax_ga.make_complete_pairs(4)
    scores = np.asarray([1.0, 2.0, 2.0, 0.5, 2.0, 1.0, 0.5, 0.5, 2.0, 1.0, 1.0, 2.0], np.float32)
    assert port_ga._spanning_tree(4, edges, scores) == jax_ga._spanning_tree(4, edges, scores)


@pytest.mark.parametrize("b2,schedule", [(0.9, "cosine"), (0.999, "cosine"), (0.9, "linear")])
def test_adam_and_schedules_match_optax(b2, schedule):
    """A toy objective with a frozen row, ten steps: the parameters and the losses."""
    rng = np.random.RandomState(4)
    x0, target = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5).astype(np.float32)
    sched = (optax.cosine_decay_schedule(0.05, 10) if schedule == "cosine"
             else optax.linear_schedule(0.05, 0.005, 10))
    opt = optax.adam(sched, b1=0.9, b2=b2)

    def loss(p):
        return jnp.sum(jnp.sin(p["x"]) * target + p["x"] ** 2)

    p, st, losses = {"x": jnp.asarray(x0)}, None, []
    st = opt.init(p)
    for _ in range(10):
        val, g = jax.value_and_grad(loss)(p)
        g = {"x": g["x"].at[1].set(0.0)}
        up, st = opt.update(g, st)
        p = optax.apply_updates(p, up)
        losses.append(float(val))
    t = torch.from_numpy(target)
    got, got_losses = port_ga.adam_run({"x": torch.from_numpy(x0)}, lambda q: (torch.sin(q["x"]) * t + q["x"] ** 2).sum(),
                                       0.05, 10, 0.9, b2, {"x": 1}, schedule)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(p["x"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-6)
    np.testing.assert_array_equal(got["x"][1].numpy(), x0[1])


# ------------------------------------------------------------------ the wrappers


def small_case(jax_wrapper, port_model, images, **priors):
    shapes = jax.eval_shape(lambda: jax_wrapper.init(jax.random.PRNGKey(0), jnp.asarray(images), **{
        k: jnp.asarray(v) for k, v in priors.items()}))["params"]
    params = seeded_params(shapes, 15)
    load_jax_params(port_model, params)
    return {"params": params}


def test_dust3r_ba_matches_jax(record_property):
    images = np.random.RandomState(8).randn(1, 3, 32, 48, 3).astype(np.float32)
    kw = dict(global_optim_niter=10)
    jax_w = jax_dust3r_ba.DUSt3RBAWrapper(JaxDUSt3RConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=64, dec_depth=2, dec_num_heads=4,
        dpt_feature_dim=32, dpt_layer_dims=(16, 32, 48, 64), indices=(0, 0, 1)), **kw)
    port = init_model("dust3r_ba", size="small", device="cpu", **kw)
    assert isinstance(port, port_external.DUSt3RBAWrapper)
    params = small_case(jax_w, port, images)
    want = jax_w.apply(params, jnp.asarray(images))
    got = port(torch.from_numpy(images))
    record_property("max_err_over_magnitude", close_views(got, want))


def test_pow3r_ba_matches_jax_with_priors(record_property):
    x = pow3r_inputs()
    rng = np.random.RandomState(9)
    images = np.concatenate([x["images"], rng.randn(1, 1, 32, 48, 3).astype(np.float32)], 1)
    K = np.concatenate([x["intrinsics"], x["intrinsics"][:, :1]], 1)
    depth = np.concatenate([x["depthmaps"], x["depthmaps"][:, :1] * 1.5], 1)
    poses = np.concatenate([x["camera_poses"], x["camera_poses"][:, 1:] @ x["camera_poses"][:, 1:]], 1)
    kw = dict(global_optim_niter=10)
    jax_w = jax_pow3r.Pow3RBAWrapper(jax_pow3r.Pow3RConfig.small(), **kw)
    port = init_model("pow3r_ba", size="small", device="cpu", **kw)
    priors = {"rays": np.stack([np.asarray(jax_pow3r.intrinsics_to_ray_prior(jnp.asarray(K[:, v]), 32, 48))
                                for v in range(2)], 1),
              "depth_prior": np.stack([np.asarray(jax_pow3r.depth_to_depth_prior(jnp.asarray(depth[:, v])))
                                       for v in range(2)], 1),
              "relpose": np.asarray(jax_pow3r.poses_to_relpose_prior(jnp.asarray(poses[:, 0]), jnp.asarray(poses[:, 1])))}
    params = small_case(jax_w, port, images, **priors)
    want = jax_w.apply(params, jnp.asarray(images), intrinsics=K, depthmaps=depth, camera_poses=poses)
    got = port(*(torch.from_numpy(a) for a in (images, K, depth, poses)))
    record_property("max_err_over_magnitude", close_views(got, want))


def test_mast3r_sga_matches_jax(record_property):
    """Ten steps of the 3-D phase, two of the reprojection phase: with seeded weights the
    matched points sit near the cameras' z = 0 clamp, where the reprojection gradients
    reach 1e7 and a step's fp32 rounding grows about 10x a step (3e-4 after ten)."""
    images = np.random.RandomState(10).randn(1, 3, 32, 48, 3).astype(np.float32)
    kw = dict(sparse_ga_niter1=10, sparse_ga_niter2=2, matching_subsample=4)
    jax_w = jax_mast3r.MASt3RSGAWrapper(jax_mast3r.MASt3RConfig.small(), **kw)
    port = init_model("mast3r_sga", size="small", device="cpu", **kw)
    params = small_case(jax_w, port, images)
    want = jax_w.apply(params, jnp.asarray(images))
    got = port(torch.from_numpy(images))
    record_property("max_err_over_magnitude", close_views(got, want))
    # The model's descriptors against the JAX model's on one pair.
    jax_out = jax.jit(jax_w.model.apply)(params, jnp.asarray(images[:, :2]))
    with torch.inference_mode():
        port_out = port_mast3r.MASt3RModel.forward(port, torch.from_numpy(images[:, :2]))
    for key in ("pts3d", "conf", "desc", "desc_conf"):
        close(port_out[key], np.asarray(jax_out[key]), name=key)


# ------------------------------------------------------------------ the matchers


def descriptor_maps(img: np.ndarray, D=8) -> np.ndarray:
    """A deterministic L2-normalised (H, W, D) descriptor map of an (H, W, 3) image."""
    proj = np.random.RandomState(12).randn(3, D).astype(np.float32)
    x = np.concatenate([img, np.roll(img, 1, axis=0), np.roll(img, 1, axis=1)], -1)[..., :3] @ proj
    x = x + 0.1 * np.sin(np.arange(img.shape[1], dtype=np.float32))[None, :, None]
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_reciprocal_matches_match_jax():
    rng = np.random.RandomState(13)
    d1, d2 = (rng.randn(24, 32, 8).astype(np.float32) for _ in range(2))
    d1, d2 = (d / np.linalg.norm(d, axis=-1, keepdims=True) for d in (d1, d2))
    want = jax_mast3r.reciprocal_matches(jnp.asarray(d1), jnp.asarray(d2), subsample=4)
    got = port_mast3r.reciprocal_matches(torch.from_numpy(d1), torch.from_numpy(d2), subsample=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(np.asarray(want[2]).sum())


def test_descriptor_tracks_match_jax():
    imgs = np.random.RandomState(14).rand(3, 24, 32, 3).astype(np.float32)

    def jax_fn(a, b):
        return jnp.asarray(descriptor_maps(np.asarray(a))), jnp.asarray(descriptor_maps(np.asarray(b)))

    def port_fn(a, b):
        return torch.from_numpy(descriptor_maps(a.numpy())), torch.from_numpy(descriptor_maps(b.numpy()))

    want = jax_tracker.predict_tracks_descriptors(jnp.asarray(imgs), jax_fn, query_frame_num=2, subsample=4)
    got = port_tracker.predict_tracks_descriptors(torch.from_numpy(imgs), port_fn, query_frame_num=2, subsample=4)
    for g, w in zip(got, want):
        close(g, w)
    depth = (1 + np.random.RandomState(15).rand(3, 24, 32)).astype(np.float32)
    K = np.tile(np.asarray([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]], np.float32), (3, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[1:, 0, 3] = [0.1, 0.2]
    want_t = jax_tracks.tracks_from_descriptor_matcher(jnp.asarray(imgs), jax_fn, K, poses, depth, query_frame_num=2,
                                                       subsample=4)
    got_t = port_tracks.tracks_from_descriptor_matcher(torch.from_numpy(imgs), port_fn, torch.from_numpy(K),
                                                       torch.from_numpy(poses), torch.from_numpy(depth),
                                                       query_frame_num=2, subsample=4)
    for f in dataclasses.fields(port_tracks.Tracks):
        close(getattr(got_t, f.name), np.asarray(getattr(want_t, f.name)), name=f.name)


def test_registry_builds_the_optimisation_baselines_and_the_tracker_on_cuda_or_raises():
    for name, cls in (("dust3r_ba", port_external.DUSt3RBAWrapper), ("metric_dust3r", port_external.DUSt3RBAWrapper),
                      ("pow3r_ba", port_external.Pow3RBAWrapper), ("mast3r_sga", port_external.MASt3RSGAWrapper)):
        model = init_model(name, size="small", device="cpu", seed=1)
        assert type(model) is cls and model.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                init_model(name, size="small")
    assert type(init_model("vggsfm_tracker", device="cpu")) is port_external.VGGSfMTracker
    assert init_model("mast3r_sga", size="small", device="cpu", desc_dim=24, enc_num_heads=2,
                      sparse_ga_niter1=5).niter1 == 5
    with pytest.raises(ValueError, match="size"):
        init_model("dust3r_ba", size="medium", device="cpu")
