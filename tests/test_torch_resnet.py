"""ofasys_torch's ResNet trunk and image_resnet adaptor against ofasys_tpu's.

FrozenBatchNorm, Bottleneck (stride 1 and 2, with and without the
downsample branch) at a small width, the resnet50 trunk on 32 x 32 images,
its gradients, the flax parameter tree round trip, ``freeze_resnet`` (zero
trunk gradients, weight decay still applied by adamw) and drop_path with
the per-sample mask handed over from JAX.

Both sides start from the same perturbed flax parameters (statistics and
affine leaves moved off their init values, so each one matters).

Tolerances:
  * fp32: atol 1e-5 on a norm or a block, relative Frobenius 1e-5 on the
    trunk (53 convolutions summed in another order by XLA and oneDNN;
    measured 8e-7);
  * bf16 trunk: relative Frobenius 1e-2. Both sides round every conv
    output and every norm to bf16 (8 bits of mantissa, 2^-9 relative
    each), but accumulate the products in different orders and XLA may
    keep a fused norm in fp32; measured 2.2e-3;
  * gradients: computed in fp64 on both sides (``jax.enable_x64``; the
    parameters stay fp32, as ``param_dtype`` keeps them), atol 1e-9 + rtol
    1e-7 of the leaf's largest entry. In fp32 the two sides' pre-activations
    differ by ~1e-6, and a ReLU input that close to 0 takes the other side
    of the kink on one of them: at 32 x 32 one such flip in the last block
    moved a column of its conv1 kernel gradient by 100% (the port's fp32
    gradient agrees with its own fp64 one to 1e-6; so does JAX's fp32
    gradient with the port's where no input sits at a kink). In fp64 the
    trunk's pre-activations are 1e-15 apart, far below any kink; the
    adaptor's LayerNorms still compute their statistics in fp32 on the
    port's side (as on the card) and in fp64 on JAX's, so the embeddings
    and gradients carry fp32 rounding of the normalized values: embed atol
    1e-6, gradients atol 1e-9 + rtol 1e-5 of the leaf's largest entry;
  * parameters after one adamw update: atol 1e-6 (the update is lr-sized).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JModality
from ofasys_tpu.adaptor import image as jimage
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.model import resnet as jresnet
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, ModalityType
from ofasys_torch.adaptor import image as timage
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.model import resnet as tresnet
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch

SIZE = 32
FP32_ATOL = 1e-5
TRUNK_FP32_REL = 1e-5
TRUNK_BF16_REL = 1e-2
GRAD_ATOL, GRAD_RTOL = 1e-9, 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(params, seed=0):
    """Statistics and affine leaves moved off init: mean/bias +-0.1, scale
    and var within [0.8, 1.2]."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ("mean", "bias"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------ small modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batch_norm_matches_flax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    jm = jresnet.FrozenBatchNorm(16, dtype=getattr(jnp, dtype))
    params = _perturb(jm.init(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    tm = tresnet.FrozenBatchNorm(16)
    load_jax_params(tm, params)
    assert all(p.requires_grad for p in tm.parameters()) and len(list(tm.parameters())) == 4
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    else:
        # inv and shift cast to bf16, then a bf16 multiply-add: within one
        # bf16 step of the output on either side's rounding
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("cin,features,stride", [(32, 8, 1), (16, 8, 1), (16, 8, 2)],
                         ids=["identity", "downsample", "stride2"])
def test_bottleneck_matches_flax(cin, features, stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    jm = jresnet.Bottleneck(features, stride, dtype=jnp.float32)
    params = _perturb(jm.init(jax.random.PRNGKey(3), x)["params"], seed=stride)
    assert ("downsample_conv" in params) == (cin != 4 * features or stride != 1)
    want = np.asarray(jm.apply({"params": params}, x))
    tm = tresnet.Bottleneck(cin, features, stride, dtype=torch.float32)
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-9 // stride), -(-7 // stride), 4 * features)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_drop_path_mask_from_jax(monkeypatch):
    """JAX's per-sample drop_path draw is read off its output (a dropped
    sample is relu(residual)), handed to the port's dropout and the whole
    block compared."""
    rng = np.random.default_rng(4)
    B, rate = 8, 0.5
    x = rng.standard_normal((B, 6, 6, 32)).astype(np.float32)
    jm = jresnet.Bottleneck(8, 1, drop_path_rate=rate, dtype=jnp.float32)
    params = _perturb(jm.init(jax.random.PRNGKey(5), x)["params"])
    want = np.asarray(jm.apply({"params": params}, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(6)}))
    dropped = np.all(want == np.maximum(x, 0), axis=(1, 2, 3))
    assert 0 < dropped.sum() < B

    calls = []

    def handed_over(y, r, generator, shape=None):
        calls.append((r, shape))
        keep = torch.from_numpy(~dropped).reshape(shape)
        return torch.where(keep, y / float(torch.tensor(1.0 - r, dtype=y.dtype)), torch.zeros((), dtype=y.dtype))

    monkeypatch.setattr(tresnet, "dropout", handed_over)
    tm = tresnet.Bottleneck(32, 8, 1, drop_path_rate=rate, dtype=torch.float32)
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.Generator()).numpy()
    assert calls == [(rate, (B, 1, 1, 1))]
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_port_drop_path_is_per_sample():
    """The port's own draw: a sample's branch is dropped whole or scaled by
    1/keep whole; rate 0 or no generator leaves the block deterministic."""
    torch.manual_seed(0)
    tm = tresnet.Bottleneck(32, 8, 1, drop_path_rate=0.5, dtype=torch.float32)
    tresnet.init_resnet_(tm, torch.Generator().manual_seed(0))
    x = torch.randn(16, 5, 5, 32)
    with torch.no_grad():
        det = tm(x)
        out = tm(x, torch.Generator().manual_seed(1))
        branch = tm.bn3(tm.conv3(torch.relu(tm.bn2(tm.conv2(torch.relu(tm.bn1(tm.conv1(x))))))))
    dropped = torch.all(out == torch.relu(x), dim=(1, 2, 3))
    kept = torch.all(torch.isclose(out, torch.relu(2 * branch + x), atol=1e-6), dim=(1, 2, 3))
    assert torch.all(dropped | kept) and 0 < int(dropped.sum()) < 16
    assert torch.equal(det, torch.relu(branch + x))


# ----------------------------------------------------------------- trunk
@pytest.fixture(scope="module")
def trunk():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jresnet.ResNet("resnet50", dtype=jnp.float32)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(8), x)["params"], seed=9)
    return x, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_trunk_matches_flax(trunk, dtype):
    x, params = trunk
    jm = jresnet.ResNet("resnet50", dtype=getattr(jnp, dtype))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x).astype(jnp.float32))
    tm = tresnet.ResNet("resnet50", dtype=getattr(torch, dtype))
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, SIZE // 16, SIZE // 16, 1024)
    rel = _rel(got.float().numpy(), want)
    assert rel < (TRUNK_FP32_REL if dtype == "float32" else TRUNK_BF16_REL), rel


def test_resnet_param_tree_round_trip(trunk):
    """The flax tree goes into the port and comes back leaf for leaf: conv
    kernels keep (kh, kw, Cin, Cout) (a 4-D kernel is never transposed),
    norms keep scale/bias/mean/var, all of them parameters."""
    _, params = trunk
    tm = tresnet.ResNet("resnet50", dtype=torch.float32)
    load_jax_params(tm, params)
    assert tuple(tm.conv1.kernel.shape) == (7, 7, 3, 64)
    assert tuple(tm.layer2_0.conv2.kernel.shape) == (3, 3, 128, 128)
    assert tuple(tm.layer3_0.downsample_conv.kernel.shape) == (1, 1, 512, 1024)
    np.testing.assert_array_equal(tm.layer1_0.conv2.kernel.detach().numpy(),
                                  params["layer1_0"]["conv2"]["kernel"])
    names = {n.rsplit(".", 1)[-1] for n, _ in tm.named_parameters()}
    assert names == {"kernel", "scale", "bias", "mean", "var"} and not list(tm.buffers())
    back, want = _flat(export_params(tm)), _flat(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown resnet_type"):
        tresnet.ResNet("resnet18")


def _tiny(m):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = 0.0
    return m


@pytest.mark.parametrize("freeze", [False, True], ids=["trained", "frozen"])
def test_image_resnet_adaptor_gradients_and_adamw_match_jax(trunk, freeze):
    """The image_resnet adaptor (resnet50 trunk, image_proj, grid
    positions) on 32 x 32 images: output, gradients of one loss and the
    parameters after one adamw update with weight decay, computed in fp64
    (module docstring). Under ``freeze_resnet`` every trunk gradient is zero
    on both sides and the decay still moves the trunk's leaves."""
    x, trunk_params = trunk
    jm, tm = _tiny(JModel(arch="tiny")), _tiny(GeneralistModel(arch="tiny"))
    acfg = dict(resnet_type="resnet50", freeze_resnet=freeze)
    rng = np.random.default_rng(11)
    w_embed = rng.standard_normal((2, 4, 64))
    w_pos = rng.standard_normal((1, 4, 64))
    with jax.enable_x64(True):
        jad = jimage.ImageResnetAdaptor(cfg=jm.cfg, adaptor_cfg=jimage.ImageResnetAdaptorConfig(**acfg),
                                        is_src=True, embed_tokens=nn.Embed(16, 64), pad_id=1,
                                        dtype=jnp.float64)
        jslot = JSlotBatch(JModality.IMAGE, True, value={"inputs": jnp.asarray(x, jnp.float64)},
                           column_name="img")
        params = jax.device_get(jax.jit(jad.init)(jax.random.PRNGKey(10), jslot)["params"])
        params["embed_images"] = trunk_params

        def jloss(p):
            out = jad.apply({"params": p}, jslot)
            return jnp.sum(out.embed * w_embed) + jnp.sum(out.pos_embed * w_pos), out.embed

        (jl, jembed), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        jl, jembed, jgrads = float(jl), np.asarray(jembed), jax.device_get(jgrads)
    assert jembed.dtype == np.float64 and all(a.dtype == np.float32 for a in jax.tree.leaves(jgrads))

    tad = timage.ImageResnetAdaptor(tm.cfg, True, torch.nn.Embedding(16, 64), 1, torch.float64,
                                    timage.ImageResnetAdaptorConfig(**acfg))
    load_jax_params(tad, params)
    names, tparams = zip(*tad.named_parameters())
    tslot = SlotBatch(ModalityType.IMAGE, True, value={"inputs": torch.from_numpy(x)}, column_name="img")
    out = tad(tslot)
    assert out.modal_id == ModalityType.IMAGE.value - 1 == 1 and out.embed.dtype == torch.float64
    np.testing.assert_allclose(out.embed.detach().numpy(), jembed, rtol=0, atol=1e-6)
    tl = torch.sum(out.embed * torch.from_numpy(w_embed)) + torch.sum(out.pos_embed * torch.from_numpy(w_pos))
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-6)
    g = torch.autograd.grad(tl, tparams, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x.float() for x, p in zip(g, tparams)]
    tgrads = _flat(export_params(tad, dict(zip(names, g))))
    jg = _flat(jgrads)
    assert tgrads.keys() == jg.keys()
    trunk_keys = [k for k in jg if k.startswith("['embed_images']")]
    assert len(trunk_keys) == len(_flat(trunk_params))
    for k in jg:
        if freeze and k in trunk_keys:
            assert not np.any(jg[k]) and not np.any(tgrads[k]), k
            continue
        tol = GRAD_ATOL + GRAD_RTOL * float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tgrads[k], jg[k], rtol=0, atol=tol, err_msg=k)
    if not freeze:
        assert all(np.any(jg[k]) for k in trunk_keys)

    # one adamw update with weight decay, JAX's gradients on both sides
    opts = dict(lr=(1e-2,), weight_decay=0.1, clip_norm=0.0)
    jopt = jbuild_optimizer(JOptimizationConfig(**opts), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(**opts), total_num_update=10)
    upd, _ = jopt.update(jgrads, jopt.init(params), params)
    jnew = _flat(optax.apply_updates(params, upd))
    holder = timage.ImageResnetAdaptor(tm.cfg, True, torch.nn.Embedding(16, 64), 1, torch.float64,
                                       timage.ImageResnetAdaptorConfig(**acfg))
    load_jax_params(holder, jgrads)
    with torch.no_grad():
        plist = list(tparams)
        topt.step(plist, [p.detach() for p in holder.parameters()], topt.init(plist))
    tnew = _flat(export_params(tad))
    before = _flat(params)
    for k in jnew:
        np.testing.assert_allclose(tnew[k], jnew[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    # decay moved every trunk kernel, frozen or not
    for k in trunk_keys:
        if k.endswith("['kernel']"):
            assert not np.array_equal(tnew[k], before[k]), k
