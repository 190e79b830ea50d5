"""The port's activation rematerialisation against its own unrematerialised step and the
JAX package's rematerialised step, on the CPU.

Every policy of ``models.blocks.REMAT_POLICIES`` (the JAX ``resolve_remat_policy``'s
names) on ``MapAnythingConfig.small()`` in fp32, with a drop-path rate of 0.1 in every
encoder and trunk block so that a recompute that draws other random numbers shows:
every gradient leaf equal to the bit to the step without remat, on the same weights,
inputs and seed (the port's counterpart of ``tests/test_remat.py:68``). The bytes of
the tensors saved for the backward (counted by a ``saved_tensors_hooks`` pack over
distinct storages) fall under every policy; the attention outputs and the fused qkv
projections are among them where the policy keeps them. One JAX step under
``remat=True, remat_policy="save_attn_mlp_pre"`` against the port's at the step tests'
1e-4; the view-parallel step (2 gloo ranks, the ring) with the trunk rematerialised
against the same step without remat (to the bit) and the unsharded remat step (1e-4).
"""

import numpy as np
import pytest
import torch

from mapanything_tpu.models import blocks as jax_blocks
from mapanything_tpu_torch.models import blocks as port_blocks
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.encoders.croco import CroCoEncoder
from mapanything_tpu_torch.models.info_sharing.global_attention import GlobalAttentionTransformer
from mapanything_tpu_torch.parallel.distributed import run_ranks
from mapanything_tpu_torch.tools import diagnose_lr_nan, view_parallel_ranks
from mapanything_tpu_torch.train import losses as port_losses
from mapanything_tpu_torch.utils import threads
from test_torch_port_train import STEP_CFG, assert_step_matches, jax_small_step, loss_batch_np, port_batch

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

POLICIES = list(port_blocks.REMAT_POLICIES)
SAVING = [name for name in POLICIES if name is not None and name.startswith("save_")]
B, V, HW = 1, 2, 56
DROP_PATH = 0.1


# ---------------------------------------------------------------- the policy table


def jax_policy_names(name):
    """(saved, offloaded) tag sets of the JAX policy ``name``, read from its closure, or
    None for a policy that saves no named tag (full recompute, the dot policies)."""
    policy = jax_blocks.resolve_remat_policy(name)
    if policy is None or not policy.__closure__:
        return None
    cells = dict(zip(policy.__code__.co_freevars, (c.cell_contents for c in policy.__closure__)))
    return set(cells["names_which_can_be_saved"]), set(cells.get("names_which_can_be_offloaded", ()))


@pytest.mark.parametrize("name", POLICIES)
def test_policy_keeps_the_tags_of_the_jax_policy(name):
    port = port_blocks.resolve_remat_policy(name)
    assert port.name == name
    named = jax_policy_names(name)
    if named is None:  # full recompute or a dot policy: the Dense outputs, no named tag but qkv_out and mlp_pre
        dots = name in ("dots", "dots_saveable")
        assert port.offloaded == frozenset()
        assert port.saved == (frozenset(port_blocks._DOTS) if dots else frozenset())
        return
    saved, offloaded = named
    assert set(port.saved) == saved and set(port.offloaded) == offloaded
    # every tag the policy keeps is one that the JAX package emits under it
    assert port.saved | port.offloaded <= {"attn_out", "mlp_hidden"} | set(jax_blocks.extra_tags_for_policy(name))


def test_an_unknown_policy_name_raises_in_both_packages():
    with pytest.raises(KeyError):
        jax_blocks.resolve_remat_policy("save_everything")
    with pytest.raises(KeyError):
        port_blocks.resolve_remat_policy("save_everything")
    with pytest.raises(KeyError):
        port_ma.MapAnything(port_ma.MapAnythingConfig.small(remat=True, trunk_remat_policy="save_everything"),
                            device="cpu")
    # Without remat the policy is not read, as in the JAX package.
    cfg = port_ma.MapAnythingConfig.small(info_sharing_depth=2, remat_policy="save_everything")
    model = port_ma.MapAnything(cfg, device="cpu")
    assert {b.remat for b in model.info_sharing.self_attention_blocks} == {None}
    with pytest.raises(ValueError, match="not a remat field"):
        model.configure_remat(compute_dtype="bfloat16")


def test_diagnose_tool_takes_the_jax_scripts_remat_settings():
    small, _, _ = diagnose_lr_nan.build(diagnose_lr_nan.parse_args(["--small"]))
    flagship, _, _ = diagnose_lr_nan.build(diagnose_lr_nan.parse_args([]))
    assert (small.remat, small.remat_policy) == (True, None)  # scripts/diagnose_lr_nan.py:60-66
    assert (flagship.remat, flagship.remat_policy) == (True, "save_attn_mlp_pre")


# ---------------------------------------------------------------- the small model, every policy


@pytest.fixture(scope="module")
def small():
    """The small images-only model with drop path 0.1 in every encoder and trunk block,
    seeded inputs, and its gradients without remat."""
    model = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="cpu", seed=3)
    for block in list(model.encoder.model.blocks) + list(model.info_sharing.self_attention_blocks):
        block.drop_path.rate = DROP_PATH
    img = torch.from_numpy(np.random.RandomState(21).randn(B, V, HW, HW, 3).astype(np.float32))
    batch = port_batch(loss_batch_np(B, V, HW, HW, 22, [True], [False], 0.9))
    ref = grads_of(model, img, batch)
    other_seed = grads_of(model, img, batch, seed=8)
    assert not torch.equal(ref["encoder.model.blocks.0.mlp.fc1.weight"],
                           other_seed["encoder.model.blocks.0.mlp.fc1.weight"])  # the drop path draws count
    return model, img, batch, ref


def loss_of(model, img, batch):
    preds = model(port_ma.Views(img=img))
    return port_losses.factored_geometry_scale_loss(batch, preds, port_losses.LossConfig())[0]


def grads_of(model, img, batch, seed: int = 7) -> dict:
    torch.manual_seed(seed)
    model.zero_grad(set_to_none=True)
    loss_of(model, img, batch).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", POLICIES)
def test_policy_gradients_equal_the_unrematerialised_ones(small, name):
    model, img, batch, ref = small
    model.configure_remat(remat=True, remat_policy=name)
    try:
        got = grads_of(model, img, batch)
    finally:
        model.configure_remat(remat=False, remat_policy=None)
    assert sorted(got) == sorted(ref)
    differ = [n for n, g in got.items() if not torch.equal(g, ref[n])]
    assert not differ, differ


def saved_for_backward(model, img, batch):
    """(bytes of the distinct storages that the forward and loss save for the backward,
    the shapes of the saved tensors)."""
    storages, shapes = {}, []

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        shapes.append(tuple(t.shape))
        return t

    torch.manual_seed(7)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_of(model, img, batch)
    del loss
    return sum(storages.values()), shapes


@pytest.mark.parametrize("name", ["nothing"] + SAVING)
def test_saved_bytes_fall_and_keep_the_policys_tensors(small, name, record_property):
    model, img, batch, _ = small
    cfg = model.config
    vit = model.encoder.model
    heads, width = vit.blocks[0].attn.num_heads, vit.embed_dim
    n = 1 + (HW // cfg.patch_size) ** 2
    attn_out = (B * V, n, heads, width // heads)  # each encoder block's attention output
    qkv_out = (B * V, n, 3 * width)  # its fused projection
    plain, plain_shapes = saved_for_backward(model, img, batch)
    model.configure_remat(remat=True, remat_policy=name)
    try:
        got, shapes = saved_for_backward(model, img, batch)
    finally:
        model.configure_remat(remat=False, remat_policy=None)
    record_property("saved_bytes_over_plain", got / plain)
    assert got < plain
    depth = len(vit.blocks)
    assert plain_shapes.count(attn_out) >= depth and plain_shapes.count(qkv_out) == 0  # q, k, v: views of it
    policy = port_blocks.resolve_remat_policy(name)
    assert shapes.count(attn_out) == (depth if "attn_out" in policy.saved else 0)
    assert shapes.count(qkv_out) == (depth if "qkv_out" in policy.saved else 0)


def global_attention_case(rng):
    module = GlobalAttentionTransformer(24, depth=2, dim=32, num_heads=2, indices=(0,))
    feats = torch.from_numpy(rng.randn(1, 2, 3, 3, 24).astype(np.float32))
    tokens = torch.from_numpy(rng.randn(1, 1, 24).astype(np.float32))
    return module, module.self_attention_blocks, lambda: sum(t.square().sum() for t in module(feats, tokens)[:1])


def croco_case(rng):
    module = CroCoEncoder(patch_size=8, embed_dim=32, depth=2, num_heads=2)
    img = torch.from_numpy(rng.randn(2, 24, 16, 3).astype(np.float32))
    return module, module.enc_blocks, lambda: module(img).square().sum()


@pytest.mark.parametrize("case", [global_attention_case, croco_case])
def test_full_remat_of_the_jax_remat_field_modules(case):
    """The JAX ``remat`` field of ``GlobalAttentionTransformer`` (:33, :74-75) and
    ``CroCoEncoder`` (:35, :58-59), full recompute of every block, is ``set_remat(blocks,
    True)`` in the port: gradients equal to the bit, with drop path in every block."""
    torch.manual_seed(0)
    module, blocks, loss = case(np.random.RandomState(4))
    for block in blocks:
        block.drop_path.rate = DROP_PATH
    grads = []
    for remat in (False, True):
        port_blocks.set_remat(blocks, remat)
        torch.manual_seed(5)
        module.zero_grad(set_to_none=True)
        loss().backward()
        grads.append({n: p.grad.clone() for n, p in module.named_parameters()})
    assert {b.remat.name for b in blocks} == {None}
    differ = [n for n, g in grads[1].items() if not torch.equal(g, grads[0][n])]
    assert sorted(grads[1]) == sorted(grads[0]) and not differ, differ


# ---------------------------------------------------------------- the JAX step, the view-parallel step


REMAT_CFG = dict(STEP_CFG, remat=True, remat_policy="save_attn_mlp_pre")


@pytest.fixture(scope="module")
def remat_step():
    return jax_small_step(REMAT_CFG)


def test_remat_train_step_matches_jax(remat_step, record_property):
    port = remat_step["port"]
    blocks = list(port.encoder.model.blocks) + list(port.info_sharing.self_attention_blocks)
    assert {b.remat.name for b in blocks} == {"save_attn_mlp_pre"}
    assert_step_matches(remat_step, record_property)


def test_view_parallel_step_with_trunk_remat(remat_step, tmp_path, record_property):
    """The ring step with the trunk rematerialised replays the ring in the backward: its
    gradients equal the ring step's without remat to the bit, and the unsharded remat
    step's within the step tests' 1e-4 of each leaf's magnitude."""
    s = remat_step
    results = run_ranks(view_parallel_ranks.cp_remat_steps, 2, "cpu", tmp_path / "rendezvous",
                        STEP_CFG, s["params"], s["img"], s["batch"], s["masks"], s["opt_cfg"])
    for r in results:
        assert r["differ"] == []
        # one global layer: n = 2 ring steps each way, the forward's twice under remat
        ring = {name: {k: c[k] for k in ("ring_steps", "ring_bwd_steps")} for name, c in r["counts"].items()}
        assert ring["ring"] == {"ring_steps": 2, "ring_bwd_steps": 2}
        assert ring["ring_remat"] == {"ring_steps": 4, "ring_bwd_steps": 2}
    got = results[0]
    np.testing.assert_allclose(got["losses"]["ring_remat"], got["losses"]["unsharded_remat"], rtol=1e-5)
    worst = max(got["gap_to_unsharded"].values())
    record_property("grad_gap_over_leaf_magnitude", worst)
    assert worst <= 1e-4, {n: g for n, g in got["gap_to_unsharded"].items() if g > 1e-4}
