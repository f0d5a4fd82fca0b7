"""HiFi-GAN and the pooling head of ofasys_torch against ofasys_tpu's
(model/hifigan.py, model/pooling.py): a seeded HiFi-GAN V1 generator
state_dict (weight-norm pairs, the reference's flat ``ups`` and
``resblocks`` names) through both packages' ``hifigan_to_flax_params``
gives the same waveform, the port's flax-tree export is the tree it
loaded, ``HifiGanVocoder`` reads the same weights from a ``.pt`` and an
``.npz``, an odd kernel - rate stage raises in both; the pooling head's
mean, max and first modes, with and without a padding mask, in fp32 and
bf16, and its registry entry.

Tolerances: waveforms atol 1e-5 (fp32 convolutions summed in another
order, through tanh); pooling logits atol 1e-5 in fp32, and in bf16 atol
2e-2 (bf16 pooled sums and a bf16 dense, rounded in another order).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.model import hifigan as jhg
from ofasys_tpu.model import pooling as jpool
from ofasys_tpu.utils import torch_import as jti
from ofasys_torch.configure.config_store import ConfigStore
from ofasys_torch.model import hifigan as thg
from ofasys_torch.model import pooling as tpool
from ofasys_torch.utils import torch_import as tti
from ofasys_torch.utils.jax_params import export_params, load_jax_params

from test_torch_search import _one_torch_thread  # noqa: F401

WAVE_ATOL = 1e-5
POOL_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _v1_state_dict(cfg, seed=0):
    """A HiFi-GAN V1 generator state_dict as the released checkpoints hold
    it: weight_norm pairs (weight_g, weight_v) on every convolution, the
    upsampling weights (in, out, k), a flat resblocks list. Each kernel's
    scale keeps the activations near unit size (trained weights do; at
    larger gains every stage grows the signal and the waveform saturates)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, shape):
        fan_in = shape[0] * shape[2] if name.startswith("ups") else shape[1] * shape[2]
        v = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        sd[f"{name}.weight_g"] = (rng.uniform(0.5, 1.5, (shape[0],) + (1,) * (len(shape) - 1))
                                  * np.sqrt((v.reshape(shape[0], -1) ** 2).sum(1)).reshape(
                                      (-1,) + (1,) * (len(shape) - 1))).astype(np.float32)
        sd[f"{name}.weight_v"] = v
        sd[f"{name}.bias"] = (rng.standard_normal(shape[1] if name.startswith("ups") else shape[0])
                              * 0.05).astype(np.float32)

    ch = cfg.upsample_initial_channel
    conv("conv_pre", (ch, cfg.num_mels, 7))
    n = 0
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        out = cfg.upsample_initial_channel // (2 ** (i + 1))
        conv(f"ups.{i}", (ch, out, k))
        ch = out
        for ks, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            for j in range(len(ds)):
                conv(f"resblocks.{n}.convs1.{j}", (ch, ch, ks))
                conv(f"resblocks.{n}.convs2.{j}", (ch, ch, ks))
            n += 1
    conv("conv_post", (1, ch, 7))
    return sd


@pytest.fixture(scope="module")
def vocoder():
    cfg = thg.HifiGanConfig()                        # V1: 512 channels, x256 upsampling
    sd = _v1_state_dict(cfg)
    jtree = jti.hifigan_to_flax_params(sd)
    ttree = tti.hifigan_to_flax_params(sd)
    mel = np.random.default_rng(1).standard_normal((2, 10, 80)).astype(np.float32)
    jm = jhg.HifiGanGenerator(jhg.HifiGanConfig())
    jwav = np.asarray(jax.jit(lambda p, m: jm.apply({"params": p}, m))(jtree, jnp.asarray(mel)))
    return dict(cfg=cfg, sd=sd, jtree=jtree, ttree=ttree, mel=mel, jwav=jwav)


def test_importers_give_the_same_tree(vocoder):
    flat_j = {jax.tree_util.keystr(p): np.asarray(a)
              for p, a in jax.tree_util.tree_leaves_with_path(vocoder["jtree"])}
    flat_t = {jax.tree_util.keystr(p): np.asarray(a)
              for p, a in jax.tree_util.tree_leaves_with_path(vocoder["ttree"])}
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


def test_waveform_matches(vocoder):
    tm = thg.HifiGanGenerator(vocoder["cfg"])
    load_jax_params(tm, vocoder["ttree"])
    with torch.no_grad():
        twav = tm(torch.as_tensor(vocoder["mel"])).numpy()
    assert twav.shape == vocoder["jwav"].shape == (2, 10 * 256)
    assert np.abs(vocoder["jwav"]).max() > 1e-3
    np.testing.assert_allclose(twav, vocoder["jwav"], rtol=0, atol=WAVE_ATOL)
    # the export is the tree it loaded (the upsampling kernels flipped back)
    back = export_params(tm)
    flat = dict(jax.tree_util.tree_leaves_with_path(vocoder["ttree"]))
    for path, a in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(a, np.asarray(flat[path]), err_msg=jax.tree_util.keystr(path))


def test_vocoder_reads_checkpoints(vocoder, tmp_path):
    pt = str(tmp_path / "g_v1.pt")
    torch.save({"generator": {k: torch.as_tensor(v) for k, v in vocoder["sd"].items()}}, pt)
    npz = str(tmp_path / "g_v1.npz")
    np.savez(npz, params=np.frombuffer(pickle.dumps(vocoder["ttree"]), np.uint8))
    a = thg.HifiGanVocoder(weights_path=pt, device="cpu")
    b = thg.HifiGanVocoder(weights_path=npz, device="cpu")
    assert a.hop_length == 256
    one = a(vocoder["mel"][0])
    assert one.shape == (2560,)
    np.testing.assert_allclose(one, vocoder["jwav"][0], rtol=0, atol=WAVE_ATOL)
    np.testing.assert_array_equal(b(vocoder["mel"]), a(vocoder["mel"]))
    c = thg.HifiGanVocoder(seed=3, device="cpu")
    d = thg.HifiGanVocoder(seed=3, device="cpu")
    np.testing.assert_array_equal(c(vocoder["mel"]), d(vocoder["mel"]))


def test_odd_kernel_minus_rate_raises():
    cfg = dict(upsample_rates=(3, 2), upsample_kernel_sizes=(6, 4), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
    with pytest.raises(AssertionError, match="must be even"):
        thg.HifiGanGenerator(thg.HifiGanConfig(**cfg))
    jm = jhg.HifiGanGenerator(jhg.HifiGanConfig(**cfg))
    with pytest.raises(AssertionError, match="must be even"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))


def test_small_config_matches_through_the_port_init():
    """A narrow generator with the port's own seeded init, exported to the
    flax tree ofasys_tpu runs."""
    cfg = dict(num_mels=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
               resblock_dilation_sizes=((1, 3), (1, 2)))
    tm = thg.init_hifigan_(thg.HifiGanGenerator(thg.HifiGanConfig(**cfg)), torch.Generator().manual_seed(0))
    tree = export_params(tm)
    jm = jhg.HifiGanGenerator(jhg.HifiGanConfig(**cfg))
    mel = np.random.default_rng(2).standard_normal((3, 7, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.asarray(mel))["params"], jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(lambda a: a.shape, tree)
    jwav = np.asarray(jm.apply({"params": tree}, jnp.asarray(mel)))
    with torch.no_grad():
        twav = tm(torch.as_tensor(mel)).numpy()
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=WAVE_ATOL)


# ------------------------------------------------------------------ pooling
def test_pooling_is_registered():
    assert "pooling" in ConfigStore().names("ofasys.model.extra_decoders")
    assert ConfigStore().get("ofasys.model.extra_decoders", "pooling").target_cls is tpool.OFAPoolingModel
    assert vars(tpool.PoolingDecoderConfig()) == vars(jpool.PoolingDecoderConfig())
    assert "pooling" in JConfigStore().names("ofasys.model.extra_decoders")


@pytest.mark.parametrize("mode", ["mean", "max", "first"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling_head_matches(mode, masked, dtype):
    rng = np.random.default_rng(3)
    B, T, E = 4, 9, 32
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mask = np.zeros((B, T), bool)
    if masked:
        for b, n in enumerate((9, 5, 1, 7)):
            mask[b, n:] = True
    cfg = tpool.PoolingDecoderConfig(num_classes=3, pooling=mode)
    jcfg = jpool.PoolingDecoderConfig(num_classes=3, pooling=mode)
    tmodel = tpool.OFAPoolingModel(cfg, E, getattr(torch, dtype))
    jmodel = jpool.OFAPoolingModel(jcfg)
    jmodel.head = jpool.PoolingHead(jcfg, dtype=getattr(jnp, dtype))
    params = jmodel.init_params(jax.random.PRNGKey(0), jnp.asarray(x, dtype), jnp.asarray(mask))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    load_jax_params(tmodel.head, params)
    jout = np.asarray(jmodel.apply(params, jnp.asarray(x, dtype), jnp.asarray(mask) if masked else None),
                      np.float32)
    with torch.no_grad():
        tout = tmodel(torch.as_tensor(x).to(getattr(torch, dtype)),
                      torch.as_tensor(mask) if masked else None)
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (B, 3)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=POOL_ATOL[dtype])
    # training mode draws its dropout from the generator, reproducibly
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(tmodel(xt, None, g1).detach().numpy(), tmodel(xt, None, g2).detach().numpy())
