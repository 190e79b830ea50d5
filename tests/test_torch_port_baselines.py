"""The feed-forward baselines of the port against the JAX package's, on the CPU.

VGGT, Pi3, MoGe-1, MoGe-2, AnyCalib, MUSt3R and Pow3R at their small presets (the
registry's ``size="small"``): the same seeded numpy weights (the JAX trees' shapes
from ``jax.eval_shape`` of ``init``, filled by ``seeded_params``, carried over by
``load_jax_params``) and the same inputs through the JAX wrapper (jitted once) and
the port's, on the CPU's plain attention. Each model with a ``convert_*`` also takes
a seeded state dict in the release's names, strictly, and is held to the JAX model
run on that dict's converted tree (the parts a converter leaves out enter the JAX
tree through the port's own parameter map). Unit cases: the pose encoding, Pi3's
SVD head, ``recover_focal_shift`` with and without a mask and at an even pixel count,
MUSt3R's ``recover_focal``, ``weighted_umeyama`` on a reflection, AnyCalib's
exponential map and pinhole fit, Pow3R's priors.

Tolerance: for each float output, max |port - JAX| <= 1e-4 · max(1, max |JAX|);
boolean outputs agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapanything_tpu.ba import global_alignment as jax_ga
from mapanything_tpu.geometry import camera as jax_camera
from mapanything_tpu.geometry import quaternion as jax_quat
from mapanything_tpu.models.external import anycalib as jax_anycalib
from mapanything_tpu.models.external import moge as jax_moge
from mapanything_tpu.models.external import must3r as jax_must3r
from mapanything_tpu.models.external import pi3 as jax_pi3
from mapanything_tpu.models.external import pow3r as jax_pow3r
from mapanything_tpu.models.external import vggt as jax_vggt
from mapanything_tpu.utils import torch_convert
from mapanything_tpu_torch.ba import global_alignment as port_ga
from mapanything_tpu_torch.models.external import anycalib as port_anycalib
from mapanything_tpu_torch.models.external import moge as port_moge
from mapanything_tpu_torch.models.external import must3r as port_must3r
from mapanything_tpu_torch.models.external import pi3 as port_pi3
from mapanything_tpu_torch.models.external import pow3r as port_pow3r
from mapanything_tpu_torch.models.external import vggt as port_vggt
from mapanything_tpu_torch.models.registry import init_model
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params, param_map
from test_torch_port_infer import seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RTOL = 1e-4  # of each output's magnitude


def close(got, want, name=""):
    """``got`` (torch) against ``want`` (numpy) under the file's rule; the error over
    the magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return 0.0
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=RTOL * scale, rtol=0, err_msg=name)
    return float(np.abs(got - want).max()) / scale


def close_views(got, want):
    """Per-view dicts of the port against the JAX wrapper's: every key, every view."""
    assert len(got) == len(want)
    errs = {}
    for v, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (set(g), set(w))
        for key in w:
            errs[f"{key}[{v}]"] = close(g[key], w[key], f"{key} of view {v}")
    return max(errs.values())


def uniform(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def as_torch(args):
    return {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in args.items()}


class Case:
    """A JAX wrapper and the port's over one small config and one input: the JAX tree's
    shapes, its jitted ``apply``, and a port model on the CPU."""

    def __init__(self, jax_wrapper, port_cls, cfg, inputs, port_inputs=None, jax_init_inputs=None):
        self.jax_wrapper, self.port_cls, self.cfg = jax_wrapper, port_cls, cfg
        self.inputs = inputs  # keyword arguments of the JAX apply (numpy)
        self.port_inputs = port_inputs or inputs
        init_inputs = {k: jnp.asarray(v) for k, v in (jax_init_inputs or inputs).items()}
        self.shapes = jax.eval_shape(lambda: jax_wrapper.init(jax.random.PRNGKey(0), **init_inputs))["params"]
        self._apply = jax.jit(lambda p, kw: jax_wrapper.apply({"params": p}, **kw))
        self.port = port_cls(cfg, device="cpu")

    def jax(self, params):
        return jax.tree.map(np.asarray, self._apply(params, {k: jnp.asarray(v) for k, v in self.inputs.items()}))

    def run_port(self):
        with torch.inference_mode():
            return self.port(**as_torch(self.port_inputs))


def vggt_case():
    cfg = port_vggt.VGGTConfig.small()
    return Case(jax_vggt.VGGTWrapper(jax_vggt.VGGTConfig.small()), port_vggt.VGGTWrapper, cfg,
                {"images": uniform(1, 1, 2, 42, 56, 3)})


def pi3_case(**kw):
    cfg = dataclasses.replace(port_pi3.Pi3Config.small(), **kw)
    jax_cfg = dataclasses.replace(jax_pi3.Pi3Config.small(), **kw)
    return Case(jax_pi3.Pi3Wrapper(jax_cfg), port_pi3.Pi3Wrapper, cfg,
                {"images": uniform(2, 1, 2, 42, 56, 3)})


def moge_case():
    cfg = port_moge.MoGeConfig.small()
    return Case(jax_moge.MoGeWrapper(jax_moge.MoGeConfig.small()), port_moge.MoGeWrapper, cfg,
                {"images": uniform(3, 2, 42, 56, 3)})


def moge2_case():
    cfg = port_moge.MoGe2Config.small()
    images = uniform(4, 1, 2, 42, 56, 3)
    return Case(jax_moge.MoGe2Wrapper(jax_moge.MoGe2Config.small()), port_moge.MoGe2Wrapper, cfg,
                {"images": images}, jax_init_inputs={"images": images})


def anycalib_case(**kw):
    cfg = dataclasses.replace(port_anycalib.AnyCalibConfig.small(), **kw)
    jax_cfg = dataclasses.replace(jax_anycalib.AnyCalibConfig.small(), **kw)
    return Case(jax_anycalib.AnyCalibWrapper(jax_cfg),
                port_anycalib.AnyCalibWrapper, cfg, {"images": uniform(5, 2, 56, 70, 3)})


def must3r_case():
    cfg = port_must3r.MUSt3RConfig.small()
    images = np.random.RandomState(6).randn(1, 3, 32, 48, 3).astype(np.float32)
    return Case(jax_must3r.MUSt3RWrapper(jax_must3r.MUSt3RConfig.small()), port_must3r.MUSt3RWrapper, cfg,
                {"images": images})


def pow3r_inputs():
    rng = np.random.RandomState(7)
    B, H, W = 1, 32, 48
    K = np.tile(np.asarray([[40.0, 0, W / 2], [0, 42.0, H / 2], [0, 0, 1]], np.float32), (B, 2, 1, 1))
    depth = (1.0 + rng.rand(B, 2, H, W)).astype(np.float32)
    depth[:, :, :5, :7] = 0.0  # pixels without depth
    angle = 0.3
    rot = np.asarray([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    poses[:, 1, :3, :3] = rot
    poses[:, 1, :3, 3] = [0.5, -0.1, 0.2]
    images = rng.randn(B, 2, H, W, 3).astype(np.float32)
    return {"images": images, "intrinsics": K, "depthmaps": depth, "camera_poses": poses}


def pow3r_case():
    cfg = port_pow3r.Pow3RConfig.small()
    inputs = pow3r_inputs()
    H, W = inputs["images"].shape[2:4]
    priors = {
        "images": inputs["images"],
        "rays": np.stack([np.asarray(jax_pow3r.intrinsics_to_ray_prior(jnp.asarray(inputs["intrinsics"][:, v]), H, W))
                          for v in range(2)], axis=1),
        "depth_prior": np.stack([np.asarray(jax_pow3r.depth_to_depth_prior(jnp.asarray(inputs["depthmaps"][:, v])))
                                 for v in range(2)], axis=1),
        "relpose": np.asarray(jax_pow3r.poses_to_relpose_prior(jnp.asarray(inputs["camera_poses"][:, 0]),
                                                               jnp.asarray(inputs["camera_poses"][:, 1]))),
    }
    return Case(jax_pow3r.Pow3RWrapper(jax_pow3r.Pow3RConfig.small()), port_pow3r.Pow3RWrapper, cfg, inputs,
                jax_init_inputs=priors)


CASES = {"vggt": vggt_case, "pi3": pi3_case, "moge": moge_case, "moge_2": moge2_case, "anycalib": anycalib_case,
         "must3r": must3r_case, "pow3r": pow3r_case}


@pytest.fixture(scope="module")
def cases():
    return {}


def get_case(cases, name):
    if name not in cases:
        cases[name] = CASES[name]()
    return cases[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_baseline_matches_jax(name, cases, record_property):
    case = get_case(cases, name)
    params = seeded_params(case.shapes, 11)
    want = case.jax(params)
    load_jax_params(case.port, params)
    got = case.run_port()
    record_property("max_err_over_magnitude", close_views(got, want))


# ------------------------------------------------------ release-named state dicts


def release_state(port, seed):
    """A seeded state dict in the port's (the release's) names: the port's own seeded
    initialisation with N(0, 0.02²) noise on every tensor, so that no tensor keeps its
    initial constant (LayerScale, the tokens, the norms)."""
    rng = np.random.default_rng(seed)
    return {name: (p.detach().numpy() + 0.02 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
            for name, p in port.state_dict().items()}


def to_jax_tree(port, state, names):
    """The JAX tree of the port parameters ``names`` of ``state``, through the port's
    parameter map (the inverse of each layout)."""
    inverse = {"dense": lambda x: x.T, "conv": lambda x: x.transpose(2, 3, 1, 0),
               "pointwise": lambda x: x.T[None, None], "lead_axis": lambda x: x[0], "copy": lambda x: x}
    tree = {}
    for name, (path, layout) in param_map(port).items():
        if name in names:
            *parents, leaf = path.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = inverse[layout](state[name])
    return tree


def merge(a, b):
    out = dict(a)
    for key, value in b.items():
        out[key] = merge(out[key], value) if key in out and isinstance(value, dict) else value
    return out


def leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        out.update(leaves(value, f"{prefix}{key}/") if isinstance(value, dict) else {f"{prefix}{key}": value})
    return out


def check_release_load(case, tree, state, record_property):
    """The converted tree has the JAX tree's exact leaves and shapes; the port loads the
    release-named ``state`` strictly and agrees with the JAX model on ``tree``."""
    assert torch_convert.verify_tree_shapes(tree, case.shapes) == []
    assert set(leaves(tree)) == set(leaves(case.shapes))
    want = case.jax(tree)
    case.port.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    record_property("max_err_over_magnitude", close_views(case.run_port(), want))


def test_vggt_release_state_dict_matches_convert_vggt(cases, record_property):
    case = get_case(cases, "vggt")
    state = release_state(case.port, 21)
    C = case.cfg.embed_dim
    assert state["aggregator.camera_token"].shape == (1, 2, 1, C)
    assert state["aggregator.register_token"].shape == (1, 2, case.cfg.num_register_tokens, C)
    assert {"aggregator.patch_embed.proj.weight", "aggregator.frame_blocks.3.attn.q_norm.weight",
            "aggregator.global_blocks.0.ls2.gamma", "camera_head.poseLN_modulation.1.weight",
            "camera_head.trunk.0.attn.k_norm.bias", "camera_head.pose_branch.fc2.bias",
            "camera_head.empty_pose_tokens"} <= set(state)
    tree = torch_convert.convert_vggt(state)
    tree.update(to_jax_tree(case.port, state, {k for k in state if k.startswith("depth_")}))
    check_release_load(case, tree, state, record_property)


def test_pi3_release_state_dict_matches_convert_pi3(cases, record_property):
    """With the ViT encoder (``convert_pi3`` reads a DINOv2 backbone), at its test size."""
    case = cases.setdefault("pi3_vit", pi3_case(patch_embed="vit", patch_embed_vit_size="test"))
    state = release_state(case.port, 22)
    assert state["register_token"].shape == (1, 1, 5, case.cfg.dec_embed_dim)
    assert {"encoder.register_tokens", "decoder.3.attn.q_norm.weight", "point_decoder.projects.weight",
            "camera_decoder.blocks.1.mlp.fc2.bias", "point_head.proj.weight", "camera_head.res_conv.1.res_conv3.bias",
            "camera_head.more_mlps.2.weight", "camera_head.fc_rot.bias"} <= set(state)
    check_release_load(case, torch_convert.convert_pi3(state), state, record_property)


def test_moge_release_state_dict_matches_convert_moge(cases, record_property):
    case = get_case(cases, "moge")
    state = release_state(case.port, 23)
    assert {"backbone.blocks.3.ls1.gamma", "head.projects.3.weight", "head.upsample_blocks.2.0.0.weight",
            "head.upsample_blocks.0.0.1.bias", "head.upsample_blocks.1.1.layers.3.weight",
            "head.output_block.1.2.bias"} <= set(state)
    check_release_load(case, torch_convert.convert_moge(state), state, record_property)


def test_anycalib_release_state_dict_matches_convert_anycalib(cases, record_property):
    """With the ViT backbone (``convert_anycalib`` reads ``backbone.*`` by name and the
    decoder by shape and order)."""
    case = cases.setdefault("anycalib_vit", anycalib_case(patch_embed="vit", patch_embed_vit_size="test"))
    state = release_state(case.port, 24)
    assert {"backbone.register_tokens", "dec_in.weight", "up0.weight", "up1.bias", "dec_out.weight"} <= set(state)
    check_release_load(case, torch_convert.convert_anycalib(state), state, record_property)


def test_must3r_release_state_dict_matches_convert_must3r(cases, record_property):
    """``convert_must3r`` names the decoder blocks ``decoder/block_N``; the JAX model's are
    ``decoder/dec_block_N``: the test renames them, and nothing else."""
    case = get_case(cases, "must3r")
    state = release_state(case.port, 25)
    assert {"patch_embed.proj.weight", "enc_blocks.1.attn.qkv.weight", "enc_norm.bias", "decoder_embed.weight",
            "dec_blocks.1.norm_y.weight", "dec_blocks.0.cross_attn.projk.bias", "dec_norm.weight",
            "downstream_head.proj.weight"} <= set(state)
    tree = torch_convert.convert_must3r(state)
    tree["decoder"] = {(f"dec_{k}" if k.startswith("block_") else k): v for k, v in tree["decoder"].items()}
    check_release_load(case, tree, state, record_property)


def test_pow3r_release_state_dict_matches_convert_pow3r(cases, record_property):
    case = get_case(cases, "pow3r")
    state = release_state(case.port, 26)
    converted = {"patch_embed.proj.weight", "patch_ln.weight", "enc_blocks.1.mlp.fc1.weight", "enc_norm.weight", "decoder_embed.weight",
                 "dec_blocks.1.norm_y.bias", "dec_blocks2.0.cross_attn.proj.weight", "dec_norm1.weight",
                 "dec_norm2.bias", "pose_embed.0.weight", "pose_embed.2.bias"}
    assert converted <= set(state)
    tree = torch_convert.convert_pow3r(state)
    jax_named = {k for k in state if k.split(".")[0] in ("patch_embed_rays", "patch_embed_depth", "cls_tokens",
                                                         "dec1_pre_ln", "dec2_pre_ln", "head1", "head2")}
    check_release_load(case, merge(tree, to_jax_tree(case.port, state, jax_named)), state, record_property)


# ------------------------------------------------------------------ unit cases


def test_pose_encoding_to_extri_intri_matches_jax():
    rng = np.random.RandomState(30)
    enc = rng.randn(2, 3, 9).astype(np.float32)
    enc[..., 7:] = 0.3 + rng.rand(2, 3, 2)  # FoVs in radians
    want = jax.jit(lambda e: jax_vggt.pose_encoding_to_extri_intri(e, (42, 56)))(jnp.asarray(enc))
    got = port_vggt.pose_encoding_to_extri_intri(torch.from_numpy(enc), (42, 56))
    for g, w in zip(got, want):
        close(g, w)
    R = got[0][..., :3, :3]  # the wxyz quaternion read as a rotation
    assert torch.allclose(R @ R.transpose(-1, -2), torch.eye(3).expand_as(R), atol=1e-5)
    q = enc[0, 0, 3:7] / np.linalg.norm(enc[0, 0, 3:7])
    w, x = q[0], q[1]
    assert abs(float(R[0, 0, 0, 0]) - (1 - 2 * (q[2] ** 2 + q[3] ** 2))) < 1e-5
    assert abs(float(R[0, 0, 2, 1]) - 2 * (q[2] * q[3] + w * x)) < 1e-5


def test_pi3_camera_head_orthogonalises_like_jax():
    """The pose's rotation, not the SVD's factors: their signs may differ, v·uᵀ not."""
    cfg = port_pi3.Pi3Config.small()
    head = jax_pi3.Pi3CameraHead(jax_pi3.Pi3Config.small())
    feat = np.random.RandomState(31).randn(6, 12, cfg.camera_head_dim).astype(np.float32)
    params = seeded_params(jax.eval_shape(head.init, jax.random.PRNGKey(0), jnp.asarray(feat))["params"], 32)
    want = np.asarray(jax.jit(head.apply)({"params": params}, jnp.asarray(feat)))
    m = np.random.RandomState(33).randn(5, 3, 3).astype(np.float32)
    m[0] = np.diag([1.0, 1.0, -1.0])  # a reflection: the det fix makes it a rotation
    r = port_pi3.orthogonalize(torch.from_numpy(m))
    assert torch.allclose(r @ r.transpose(-1, -2), torch.eye(3).expand(5, 3, 3), atol=1e-5)
    assert torch.allclose(torch.linalg.det(r), torch.ones(5), atol=1e-5)
    port = port_pi3.Pi3CameraHead(cfg)
    state = {}
    for i in range(2):
        for k in (1, 2, 3):
            state[f"res_conv.{i}.res_conv{k}.weight"] = params[f"res{i}_{k}"]["kernel"].T
            state[f"res_conv.{i}.res_conv{k}.bias"] = params[f"res{i}_{k}"]["bias"]
    for name, idx in (("mlp1", 0), ("mlp2", 2)):
        state[f"more_mlps.{idx}.weight"], state[f"more_mlps.{idx}.bias"] = params[name]["kernel"].T, params[name]["bias"]
    for name in ("fc_t", "fc_rot"):
        state[f"{name}.weight"], state[f"{name}.bias"] = params[name]["kernel"].T, params[name]["bias"]
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(feat))
    assert got.shape == (6, 4, 4)
    close(got, want)


def focal_shift_points(seed, n_views, H, W):
    """An affine-invariant point map: a slanted plane seen by a pinhole, shifted in z."""
    rng = np.random.RandomState(seed)
    uv = np.asarray(jax_moge.normalized_view_plane_uv(H, W))
    z = 2.0 + 0.5 * uv[..., 0] + rng.rand(n_views, H, W) * 0.1
    focal = 0.8 + rng.rand(n_views, 1, 1)
    xy = uv[None] * z[..., None] / focal[..., None]
    return np.concatenate([xy, (z - 1.3)[..., None]], axis=-1).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hw", [(40, 56), (36, 44)])
def test_recover_focal_shift_matches_jax(masked, hw):
    """At 40 x 56 the downsampled grid has 10 x 14 = 140 pixels (an even count: the median
    averages the two middle values); at 36 x 44, 9 x 11 = 99. With a mask, the JAX median
    over the NaN-masked array is NaN, which ``nan_to_num`` turns into 1.0."""
    H, W = hw
    pts = focal_shift_points(34, 3, H, W)
    mask = None
    if masked:
        mask = np.ones((3, H, W), bool)
        mask[0, :8, :8] = False  # a masked pixel in view 0's sample
        mask[2] = False  # nothing valid in view 2
    if mask is None:
        want = jax.jit(jax_moge.recover_focal_shift)(jnp.asarray(pts))
    else:
        want = jax.jit(jax_moge.recover_focal_shift)(jnp.asarray(pts), jnp.asarray(mask))
    got = port_moge.recover_focal_shift(torch.from_numpy(pts), None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w)


def test_masked_median_follows_jax_median_and_nan_to_num():
    z = np.asarray([[3.0, 1.0, 2.0, 4.0], [5.0, 1.0, 2.0, 9.0], [1.0, np.inf, 2.0, 3.0]], np.float32)
    m = np.asarray([[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1]], bool)
    want = np.asarray(jnp.nan_to_num(jnp.median(jnp.where(jnp.asarray(m), jnp.asarray(z), jnp.nan), axis=-1),
                                     nan=1.0))
    got = port_moge.masked_median_or_one(torch.from_numpy(z), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 2.5 and got[1] == 1.0


def test_must3r_recover_focal_matches_jax():
    rng = np.random.RandomState(35)
    pts = np.concatenate([rng.randn(2, 16, 24, 2), 1.0 + rng.rand(2, 16, 24, 1)], axis=-1).astype(np.float32)
    conf = (1.0 + rng.rand(2, 16, 24)).astype(np.float32)
    close(port_must3r.recover_focal(torch.from_numpy(pts), torch.from_numpy(conf)),
          jax.jit(jax_must3r.recover_focal)(jnp.asarray(pts), jnp.asarray(conf)))


def test_weighted_umeyama_matches_jax_and_never_reflects():
    rng = np.random.RandomState(36)
    src = rng.randn(3, 50, 3).astype(np.float32)
    w = rng.rand(3, 50).astype(np.float32)
    q = rng.randn(3, 4)
    R_true = np.asarray(jax_quat.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    dst = 1.7 * np.einsum("bij,bnj->bni", R_true, src) + np.asarray([0.3, -1.0, 2.0], np.float32)
    dst[2] = src[2] * np.asarray([1.0, 1.0, -1.0], np.float32)  # a mirror image: the best rotation, no reflection
    dst = dst.astype(np.float32)
    want = jax.jit(jax.vmap(jax_ga.weighted_umeyama))(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    s, R, t = port_ga.weighted_umeyama(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    for g, w_ in zip((s, R, t), want):
        close(g, w_)
    assert torch.allclose(torch.linalg.det(R), torch.ones(3), atol=1e-5)
    assert abs(float(s[0]) - 1.7) < 1e-4 and torch.allclose(R[0], torch.tensor(R_true[0]), atol=1e-4)
    np.testing.assert_array_equal(port_ga.make_complete_pairs(3), jax_ga.make_complete_pairs(3))


def test_anycalib_expmap_round_trip_and_pinhole_fit_match_jax():
    rng = np.random.RandomState(37)
    tangent = (0.6 * rng.randn(4, 7, 2)).astype(np.float32)
    tangent[0, 0] = 0.0  # the axis itself: sinc's limit
    rays = port_anycalib.expmap_to_rays(torch.from_numpy(tangent))
    close(rays, jax.jit(jax_anycalib.expmap_to_rays)(jnp.asarray(tangent)))
    assert torch.allclose(torch.linalg.norm(rays, dim=-1), torch.ones(4, 7), atol=1e-6)
    back = port_anycalib.rays_to_tangent(rays)
    close(back, jax.jit(jax_anycalib.rays_to_tangent)(jnp.asarray(rays.numpy())))
    np.testing.assert_allclose(back.numpy()[1:], tangent[1:], atol=1e-4)
    # A pinhole's rays on a 12 x 16 grid, the fit expressed at 48 x 64.
    K = np.asarray([[[20.0, 0, 7.5], [0, 18.0, 5.5], [0, 0, 1]]], np.float32)
    _, grid_rays = jax.jit(lambda k: jax_camera.rays_in_camera_frame(k, 12, 16, normalize_to_unit_sphere=True))(
        jnp.asarray(K))
    grid_rays = np.array(grid_rays)
    got = port_anycalib.fit_pinhole_from_rays(torch.from_numpy(grid_rays), (48, 64))
    close(got, jax.jit(lambda r: jax_anycalib.fit_pinhole_from_rays(r, (48, 64)))(jnp.asarray(grid_rays)))
    np.testing.assert_allclose(got.numpy()[0], K[0] * [[4, 1, 4], [1, 4, 4], [1, 1, 1]], rtol=1e-4)


def test_pow3r_priors_match_jax():
    inputs = pow3r_inputs()
    H, W = inputs["images"].shape[2:4]
    K, depth, poses = inputs["intrinsics"][:, 0], inputs["depthmaps"][:, 0], inputs["camera_poses"]
    close(port_pow3r.intrinsics_to_ray_prior(torch.from_numpy(K), H, W),
          jax_pow3r.intrinsics_to_ray_prior(jnp.asarray(K), H, W))
    close(port_pow3r.depth_to_depth_prior(torch.from_numpy(depth)), jax_pow3r.depth_to_depth_prior(jnp.asarray(depth)))
    rel = port_pow3r.poses_to_relpose_prior(torch.from_numpy(poses[:, 0]), torch.from_numpy(poses[:, 1]))
    close(rel, jax_pow3r.poses_to_relpose_prior(jnp.asarray(poses[:, 0]), jnp.asarray(poses[:, 1])))
    assert abs(float(torch.linalg.norm(rel[0, :3, 3])) - 1.0) < 1e-6


def test_registry_builds_every_feed_forward_baseline_on_cuda_or_raises():
    for name, cls in (("vggt", port_vggt.VGGTWrapper), ("moge", port_moge.MoGeWrapper),
                      ("moge_1", port_moge.MoGeWrapper), ("moge_2", port_moge.MoGe2Wrapper),
                      ("pi3", port_pi3.Pi3Wrapper), ("anycalib", port_anycalib.AnyCalibWrapper),
                      ("must3r", port_must3r.MUSt3RWrapper), ("pow3r", port_pow3r.Pow3RWrapper)):
        model = init_model(name, size="small", device="cpu", seed=1)
        assert type(model) is cls and model.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                init_model(name, size="small")
    assert init_model("vggt", size="small", device="cpu", embed_dim=128, num_heads=2).config.embed_dim == 128
    with pytest.raises(ValueError, match="size"):
        init_model("pi3", size="medium", device="cpu")
