"""The VGGSfM tracker of the port and its fp32 D = 48 attention against the JAX package, on
the CPU.

The tracker at its release widths (coarse: width 384, 8 heads of 48, depth 6; fine: width
256, depth 4) on 3 frames of 64 x 64 with 16 queries and ``coarse_iters=2``: a seeded state
dict in the reference ``TrackerPredictor``'s names, loaded by the port strictly and
converted for the JAX model by ``convert_vggsfm_tracker``; all four outputs held. At
64 x 64 the coarse features are 8 x 8, so the correlation pyramid's levels are 8, 4, 2, 1
and 0 pixels wide: the one-pixel level and the empty one are both sampled. The parts:
``bilinear_sample`` on one-pixel and empty maps, the correlation window's order,
``get_2d_embedding``. The D = 48 attention: the port's plain version (what the card's
``fa_fwd_f32_narrow<48>`` is held to) against the JAX ``flash_attention`` in interpret
mode at 1 x 1100 queries x 64 keys x 2 heads, where it takes ``_fwd_kernel_single``
(the kernel's own arithmetic at the tracker's shapes: ``tests/test_torch_port_narrow_f32.py``).

Tolerance: each output within 1e-4 of max(1, its magnitude) (tracks in pixels: 1e-3 px at
64 px); the attention within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.models.external import vggsfm_tracker as jax_vt
from mapanything_tpu.ops import flash_attention as jax_fa
from mapanything_tpu.utils import torch_convert
from mapanything_tpu_torch.ba import tracker as port_tracker
from mapanything_tpu_torch.models.external import vggsfm_tracker as port_vt
from mapanything_tpu_torch.models.registry import init_model
from mapanything_tpu_torch.ops import flash_attention as port_fa
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import jax_params_to_state_dict
from test_torch_port_baselines import release_state
from test_torch_port_headdim128 import pallas_kernels

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RTOL = 1e-4
S, HW, N, ITERS = 3, 64, 16, 2


def close(got, want, rtol=RTOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=name)
    return float(np.abs(got - want).max()) / scale


def inputs():
    rng = np.random.RandomState(0)
    images = rng.rand(1, S, HW, HW, 3).astype(np.float32)
    queries = (4 + rng.rand(1, N, 2) * (HW - 8)).astype(np.float32)
    return images, queries


@pytest.fixture(scope="module")
def tracker_run():
    """The port tracker holding a release-named seeded state dict, and the JAX tracker's
    outputs on its ``convert_vggsfm_tracker`` tree (jitted once)."""
    images, queries = inputs()
    jax_model = jax_vt.VGGSfMTracker()
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(queries),
                                                   coarse_iters=ITERS))["params"]
    port = port_vt.VGGSfMTracker(device="cpu")
    state = release_state(port, 31)
    # Steps of a pixel or so an iteration, as trained weights take, not the tens of pixels
    # that seeded ones take: those send tracks out of the frame, where fp32 rounding grows
    # into whole-pixel shifts of the fine tracker's patches (its floor of the coarse track).
    for name in ("coarse_predictor.updateformer.flow_head.weight", "fine_predictor.updateformer.flow_head.weight"):
        state[name] = state[name] * np.float32(0.01)
    tree = torch_convert.convert_vggsfm_tracker(state)
    want = jax.jit(lambda p, im, q: jax_model.apply({"params": p}, im, q, coarse_iters=ITERS))(
        tree, jnp.asarray(images), jnp.asarray(queries))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return dict(port=port, state=state, tree=tree, shapes=shapes, want=[np.asarray(w) for w in want],
                images=images, queries=queries)


def test_release_names_convert_to_the_jax_tree_and_back(tracker_run):
    """``convert_vggsfm_tracker`` of the port's state dict fills the JAX tree exactly, and
    the port's parameter map reads that tree back into the same state dict."""
    assert torch_convert.verify_tree_shapes(tracker_run["tree"], tracker_run["shapes"]) == []
    assert {"coarse_fnet.layer2.0.downsample.0.weight", "fine_fnet.layer1.conv1.bias",
            "coarse_predictor.updateformer.virual_tracks",
            "coarse_predictor.updateformer.space_point2virtual_blocks.5.norm_context.weight",
            "coarse_predictor.updateformer.time_blocks.0.attn.in_proj_weight", "coarse_predictor.vis_predictor.0.bias",
            "fine_predictor.ffeat_updater.0.weight", "fine_predictor.norm.weight"} <= set(tracker_run["state"])
    back = jax_params_to_state_dict(tracker_run["port"], tracker_run["tree"])
    assert set(back) == set(tracker_run["state"])
    for name, x in back.items():
        np.testing.assert_array_equal(x.numpy(), tracker_run["state"][name], err_msg=name)


def test_tracker_matches_jax(tracker_run, record_property):
    with torch.inference_mode():
        got = tracker_run["port"](torch.from_numpy(tracker_run["images"]), torch.from_numpy(tracker_run["queries"]),
                                  coarse_iters=ITERS)
    errs = [close(g, w, rtol=1e-3 / HW if i < 2 else RTOL, name=name) for i, (g, w, name) in
            enumerate(zip(got, tracker_run["want"], ("fine", "coarse", "vis", "score")))]
    # The query frame's tracks are the queries themselves, in both.
    np.testing.assert_allclose(got[0][0, 0].numpy(), tracker_run["queries"][0], atol=1e-5)
    record_property("max_err_over_magnitude", max(errs))


def test_coarse_only_tracking_matches_jax(tracker_run):
    jax_model = jax_vt.VGGSfMTracker()
    want = jax.jit(lambda p, im, q: jax_model.apply({"params": p}, im, q, coarse_iters=1, fine_tracking=False))(
        tracker_run["tree"], jnp.asarray(tracker_run["images"]), jnp.asarray(tracker_run["queries"]))
    with torch.inference_mode():
        got = tracker_run["port"](torch.from_numpy(tracker_run["images"]), torch.from_numpy(tracker_run["queries"]),
                                  coarse_iters=1, fine_tracking=False)
    for g, w in zip(got, want):
        close(g, np.asarray(w), rtol=1e-3 / HW)


def test_learned_tracks_map_each_query_frame_back():
    """``predict_tracks_learned``: each query frame's round runs the network on the frames
    reordered with the query first, maps them back, and keeps the query frame exact."""
    model = init_model("vggsfm_tracker", device="cpu", seed=3)
    images = inputs()[0][0]
    tracks, vis, scores = port_tracker.predict_tracks_learned(torch.from_numpy(images), model, max_query_pts=8,
                                                              query_frame_num=2, coarse_iters=1)
    queries = port_tracker.select_query_frames(images, 2)
    assert queries == [0, 2] and tracks.shape[0] == S and tracks.shape[1] == vis.shape[1] == scores.shape[1]
    uv, score = port_tracker.harris_keypoints(torch.from_numpy(images[2]), max_points=8)
    keep = (score > 0).numpy()
    with torch.inference_mode():
        fine = model(torch.from_numpy(images[[2, 0, 1]])[None], uv[None], coarse_iters=1)[0][0].numpy()
    n0 = tracks.shape[1] - int(keep.sum())  # the second round's tracks come last
    np.testing.assert_allclose(tracks[:, n0:], fine[[1, 2, 0]][:, keep], atol=1e-5)
    assert (scores[2, n0:] == 1.0).all() and vis[2, n0:].all()


# ------------------------------------------------------------------ the parts


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (0, 0), (4, 6)])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_matches_jax_on_one_pixel_and_empty_maps(hw, mode):
    rng = np.random.RandomState(sum(hw))
    img = rng.randn(2, *hw, 3).astype(np.float32)
    coords = (rng.rand(2, 4, 5, 2) * 8 - 2).astype(np.float32)
    want = jax_vt.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode=mode)
    close(port_vt.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords), mode), np.asarray(want))


def test_correlation_window_and_embeddings_match_jax():
    rng = np.random.RandomState(5)
    fmaps = rng.randn(1, 2, 8, 6, 4).astype(np.float32)
    targets = rng.randn(1, 2, 3, 4).astype(np.float32)
    coords = (rng.rand(1, 2, 3, 2) * 6).astype(np.float32)
    jp = jax_vt.CorrPyramid(jnp.asarray(fmaps), 4, 2)
    jp.corr(jnp.asarray(targets))
    pp = port_vt.CorrPyramid(torch.from_numpy(fmaps), 4, 2)
    pp.corr(torch.from_numpy(targets))
    close(pp.sample(torch.from_numpy(coords)), np.asarray(jp.sample(jnp.asarray(coords))))
    xy = (rng.randn(5, 2) * 3).astype(np.float32)
    close(port_vt.get_2d_embedding(torch.from_numpy(xy), 64), np.asarray(jax_vt.get_2d_embedding(jnp.asarray(xy), 64)))


# ------------------------------------------------------------------ D = 48


@pytest.fixture(scope="module")
def d48():
    rng = np.random.RandomState(48)
    q = rng.randn(1, 1100, 2, 48).astype(np.float32)
    k, v = (rng.randn(1, 64, 2, 48).astype(np.float32) for _ in range(2))
    scale = 48**-0.5
    o, ran = pallas_kernels(lambda: jax_fa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), scale,
                                                           block_q=128, block_k=128, interpret=True))
    return dict(inputs=[torch.from_numpy(x) for x in (q, k, v)], scale=scale, o=np.asarray(o), ran=ran)


def test_d48_plain_attention_matches_the_jax_single_pass_kernel(d48, record_property):
    assert d48["ran"] == ["_fwd_kernel_single"]
    got = port_fa.flash_attention(*d48["inputs"], d48["scale"])  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), d48["o"], atol=2e-5, rtol=0)
    record_property("max_abs_err", float(np.abs(got.numpy() - d48["o"]).max()))


def test_d48_has_the_lse_free_forward_alone():
    x = torch.zeros(1, 8, 2, 48)
    port_fa._check(x, x, x)
    with pytest.raises(ValueError, match="head dim 48"):
        port_fa._check(x, x, x, lse=True)
