"""Build the system under test from a configuration file: the dictionary in
the published OFA layout, the port's preprocessors, the port's model with
weights made on the device from the seed, and the hub that serves it.

Weights are the benchmark's, not the port's initializer's: one draw of
standard normals on the device from a ``torch.Generator``, cut into the
parameters in their named order and scaled by a rule on the leaf's name and
shape (:func:`scale_leaf`). The reference gets the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

SEED_MASK = (1 << 63) - 1
# about 1% of every LayerNorm's channels carry a gain of 12: the outlier
# features of trained transformers, which an int8 path with one scale a row
# cannot hold and bfloat16 can
OUTLIER_Z = 2.576
OUTLIER_GAIN = 12.0


def generator(device, seed: int) -> torch.Generator:
    """The generator of the run's weights on ``device``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + 1) & SEED_MASK)


def scale_leaf(name: str, z: torch.Tensor) -> torch.Tensor:
    """A parameter from standard normals ``z`` by its name and shape:
    fan-in scaled products and convolutions, 0.02 embeddings and biases,
    LayerNorm gains near 1 with about 1% of channels at OUTLIER_GAIN, head
    scales near 1, frozen batch-norm statistics near the identity,
    relative-position tables at 0.1."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":                                   # (k, k, Cin, Cout)
        return z / math.sqrt(z[..., 0].numel())
    if leaf == "weight" and z.dim() == 2:
        return z * 0.02 if "embed" in name else z / math.sqrt(z.shape[1])
    if leaf == "weight" and z.dim() == 1:                  # LayerNorm
        return torch.where(z.abs() > OUTLIER_Z, OUTLIER_GAIN, 1.0 + 0.05 * z)
    if leaf in ("bias", "type_embedding"):
        return 0.02 * z
    if leaf in ("scale", "c_attn"):
        return 1.0 + 0.05 * z
    if leaf == "mean":
        return 0.05 * z
    if leaf == "var":
        return 1.0 + 0.1 * z.abs()
    if leaf in ("rel_pos_table", "image_rel_pos_table"):
        return 0.1 * z
    raise KeyError(f"no weight rule for parameter {name!r}")


@torch.no_grad()
def weight_tensors(shapes: Sequence[Tuple[str, torch.Size]], seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for parameters of these names and shapes:
    one draw of standard normals on ``device``, cut in this order, scaled
    by :func:`scale_leaf` and rounded to values that bfloat16 holds
    exactly, so that the program's casts to its compute dtype lose nothing
    and the comparison with the float32 reference sees the precision of its
    arithmetic alone. The same seed gives the same tensors."""
    total = sum(math.prod(s) for _, s in shapes)
    z = torch.randn(total, generator=generator(device, seed), device=device)
    out, o = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = scale_leaf(name, z[o:o + n].view(shape)).to(torch.bfloat16).float()
        o += n
    return out


def shapes_of(net) -> List[Tuple[str, torch.Size]]:
    return [(n, p.shape) for n, p in net.named_parameters()]


@torch.no_grad()
def seed_weights(net, seed: int) -> None:
    """Fill the net's parameters in place with the benchmark's weights."""
    device = next(net.parameters()).device
    w = weight_tensors(shapes_of(net), seed, device)
    for name, p in net.named_parameters():
        p.copy_(w[name])


def dictionary(cfg: Dict, active: Sequence[str]):
    """The published OFA vocabulary: specials, the BPE rows, <mask>, the
    <bin> rows, the <code> rows, padded to a multiple of 8; and the port's
    preprocessors over it."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = Dictionary()
    for i in range(cfg["vocab_text"]):
        d.add_symbol(f"<text>_{i}")
    gp = GeneralPreprocess(d, active=list(active))
    if "box" not in active:
        d.add_namespace("<bin>", cfg["vocab_bins"])
    d.add_namespace("<code>", cfg["vocab_codes"])
    d.pad_to_multiple_(8)
    return d, gp


def model_config(cfg: Dict, dropout: float = 0.0, attention_dropout: float = 0.0):
    """The port's model config for the arch the file names, with the file's
    sizes (the repo's cells keep each arch's preset; a test holds that)."""
    from ofasys_torch.model.config import GeneralistModelConfig

    mc = GeneralistModelConfig(arch=cfg["arch"])
    for side in ("encoder", "decoder"):
        stack = getattr(mc, side)
        for key in ("embed_dim", "ffn_embed_dim", "layers", "attention_heads"):
            setattr(stack, key, cfg[f"{side}_{key}"])
    mc.max_source_positions = cfg["max_source_positions"]
    mc.max_target_positions = cfg["max_target_positions"]
    mc.dropout = dropout
    mc.attention_dropout = attention_dropout
    return mc


def build_model(cfg: Dict, d, adaptors: Sequence[str], device, seed: int,
                dropout: float = 0.0, attention_dropout: float = 0.0):
    """The port's GeneralistModel with its net built on ``device`` and the
    benchmark's weights."""
    from ofasys_torch import GeneralistModel
    from ofasys_torch.adaptor.image import ImageResnetAdaptorConfig
    from ofasys_torch.model.ofa import GeneralistNet

    mc = model_config(cfg, dropout, attention_dropout)
    model = GeneralistModel(cfg=mc)
    dtype = getattr(torch, cfg["compute_dtype"])
    with torch.device(device):
        net = GeneralistNet(model.cfg, vocab_size=len(d), pad_id=d.pad(), active_adaptors=tuple(adaptors),
                            dtype=dtype, adaptor_cfgs={"image_resnet": ImageResnetAdaptorConfig(
                                resnet_type=cfg["resnet_type"])})
    seed_weights(net, seed)
    model.net = net.eval()
    model.global_dict = d
    return model
