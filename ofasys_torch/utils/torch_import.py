"""Reference OFASys checkpoints into the port (counterpart of
ofasys_tpu/utils/torch_import.py).

The released checkpoints (``multitask_10k.pt`` and the others) hold a
torch state_dict with fairseq naming: ``encoder.``/``decoder.`` prefixes,
adaptor submodules, ``token_rel_pos_table_list`` ModuleLists. The port
names every parameter by its flax path (utils/jax_params.py), so the
mapping is ofasys_tpu's, from each flax path to its reference key, with
these layout transforms:

  torch Linear weight (out, in)   -> flax kernel (in, out)      [transpose]
  torch Embedding weight          -> flax embedding
  torch LayerNorm weight/bias     -> flax scale/bias
  torch Conv2d (out, in, kh, kw)  -> flax (kh, kw, in, out)
  rel-pos ModuleList of L tables  -> one stacked (L, nb, H) param
  BatchNorm running stats         -> FrozenBatchNorm mean/var

``taming_to_flax_params`` maps a taming-transformers GumbelVQ state_dict
onto the flax-path tree of model/vqgan.py's ``GumbelVQ`` (conv OIHW ->
HWIO, GroupNorm weight -> scale), and ``hifigan_to_flax_params`` a HiFi-GAN
V1 generator's onto model/hifigan.py's (weight norm fused, Conv1d OIk ->
kIO, ConvTranspose1d IOk -> kIO flipped), which ``load_jax_params`` then
loads.

``import_reference_state_dict`` goes reference names -> the flax-path tree
-> ``load_jax_params``; ``export_reference_state_dict`` goes
``export_params`` -> reference names. ``python -m
ofasys_torch.utils.torch_import ref.pt out_dir ...`` writes a checkpoint
that ``OFASys.from_pretrained(out_dir + '/checkpoint_last')`` loads.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def _walk(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(flax path, leaf) of a nested dict, keys sorted at every level (the
    order of ``jax.tree_util``'s flattening)."""
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], p)
        else:
            yield p, tree[k]


def _put(tree: Dict[str, Any], path: str, leaf: Any):
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def flax_to_reference_key(path: str) -> Optional[Tuple[str, str]]:
    """A flax param path -> (reference key, transform); transform in
    {'linear', 'embed', 'row', 'rel_stack', 'direct'}."""
    p = path

    # the shared token embedding (registered under both adaptors in the
    # reference; the encoder's copy is canonical)
    if p == "embed_tokens/embedding":
        return "encoder.adaptor.embed_tokens.weight", "embed"

    m = re.match(r"(encoder|decoder)_adaptor/(.+)", p)
    if m:
        side, rest = m.group(1), m.group(2)
        base = f"{side}.adaptor"
        if rest.startswith(("pos_q_linear", "pos_k_linear")):
            name, leaf = rest.split("/")
            return f"{base}.{name}.{'weight' if leaf == 'kernel' else 'bias'}", \
                ("linear" if leaf == "kernel" else "direct")
        # per-adaptor params: text/..., image_resnet/..., ...
        adaptor, sub = rest.split("/", 1)
        ab = f"{base}.{adaptor}"
        if sub.startswith("embed_images/"):
            # the ResNet trunk (torchvision naming): layer{s}_{i} -> layer{s}.{i},
            # downsample_conv/_bn -> downsample.0/.1, FrozenBatchNorm
            # mean/var -> the running-stat buffers
            r = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", sub)
            r = r.replace("downsample_conv", "downsample.0")
            r = r.replace("downsample_bn", "downsample.1")
            name, leaf = r.rsplit("/", 1)
            torch_leaf = {
                "kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var",
            }[leaf]
            return f"{ab}.{name.replace('/', '.')}.{torch_leaf}", \
                ("linear" if leaf == "kernel" else "direct")
        if sub == "rel_pos_table":
            return f"{ab}.token_rel_pos_table_list", "rel_stack"
        if sub == "image_rel_pos_table":
            return f"{ab}.image_rel_pos_table_list", "rel_stack"
        if sub == "type_embedding":
            # torch nn.Embedding(1, E).weight is (1, E); the port's is a bare row
            return f"{ab}.type_embedding.weight", "row"
        if sub.endswith("/embedding"):
            name = sub[: -len("/embedding")]
            return f"{ab}.{name}.weight", "embed"
        if "/scale" in sub or "/bias" in sub:
            name, leaf = sub.rsplit("/", 1)
            torch_leaf = "weight" if leaf == "scale" else "bias"
            return f"{ab}.{name.replace('/', '.')}.{torch_leaf}", "direct"
        if sub.endswith("/kernel"):
            name = sub[: -len("/kernel")].replace("/", ".")
            return f"{ab}.{name}.weight", "linear"
        return f"{ab}.{sub.replace('/', '.')}", "direct"

    m = re.match(r"(encoder|decoder)/layers_(\d+)/(.+)", p)
    if m:
        side, i, rest = m.groups()
        base = f"{side}.layers.{i}"
        # ffn/* maps to the flat fc1/fc2/ffn_layernorm of the reference; the
        # attention LayerNorm names already match
        rest = rest.replace("ffn/fc2_ln", "ffn_layernorm").replace("ffn/", "")
        if rest.endswith("/kernel"):
            return f"{base}.{rest[:-7].replace('/', '.')}.weight", "linear"
        if rest.endswith("/scale"):
            return f"{base}.{rest[:-6].replace('/', '.')}.weight", "direct"
        if rest.endswith("/bias"):
            return f"{base}.{rest[:-5].replace('/', '.')}.bias", "direct"
        if rest.endswith("c_attn"):
            return f"{base}.{rest.replace('/', '.')}", "direct"
        if rest == "w_resid":
            return f"{base}.w_resid", "direct"
        return f"{base}.{rest.replace('/', '.')}", "direct"

    m = re.match(r"(encoder|decoder)/layer_norm/(scale|bias)", p)
    if m:
        side, leaf = m.groups()
        return f"{side}.layer_norm.{'weight' if leaf == 'scale' else 'bias'}", "direct"

    m = re.match(r"cross_pos_([qk])_linear/(kernel|bias)", p)
    if m:
        qk, leaf = m.groups()
        return f"decoder.cross_pos_{qk}_linear.{'weight' if leaf == 'kernel' else 'bias'}", \
            ("linear" if leaf == "kernel" else "direct")
    return None


def _to_flax(value: np.ndarray, transform: str, target_shape) -> np.ndarray:
    v = np.asarray(value)
    if transform == "linear":
        # every torch weight that lands on a flax kernel: 2D Linear (O, I) ->
        # (I, O) and 3D Conv1d (O, I, k) -> (k, I, O) by full reversal; 4D
        # Conv2d (O, I, kh, kw) -> HWIO by the conv permutation (a full
        # reversal transposes the taps of a square kernel)
        v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
    elif transform == "conv":
        v = v.transpose(2, 3, 1, 0)
    elif transform == "row":
        v = v.reshape(-1)
    if tuple(v.shape) != tuple(target_shape) and v.ndim == 4 and len(target_shape) == 4:
        v = v.transpose(2, 3, 1, 0)
    if (
        tuple(v.shape) != tuple(target_shape)
        and v.ndim == len(target_shape) + 1
        and v.shape[0] == 1
        and tuple(v.shape[1:]) == tuple(target_shape)
    ):
        v = v[0]
    return v


def _adapt_vocab_axis(v: np.ndarray, leaf: np.ndarray) -> Optional[np.ndarray]:
    """An embedding-like param whose leading (vocab) axis differs only by
    padding (fairseq pads the vocabulary to a multiple of 8, the trainer to
    128): the overlapping rows copied onto the target leaf, which keeps its
    own extra rows; None if the shapes differ in any other way."""
    if v.ndim != np.asarray(leaf).ndim or v.ndim < 1:
        return None
    if tuple(v.shape[1:]) != tuple(np.asarray(leaf).shape[1:]):
        return None
    n = min(v.shape[0], leaf.shape[0])
    out = np.array(np.asarray(leaf), copy=True)
    out[:n] = v[:n]
    return out


def _net(model) -> nn.Module:
    return model.net if hasattr(model, "net") else model


def import_reference_state_dict(
    state_dict: Dict[str, np.ndarray],
    model,
    strict: bool = False,
) -> Tuple[Any, List[str], List[str]]:
    """Load a reference state_dict into ``model`` (a GeneralistModel or its
    net) in place. Returns (model, missing, unused): the flax paths left at
    the model's own values and the state_dict keys not used, in
    ofasys_tpu's order. ``strict`` raises ``KeyError`` on any missing path."""
    from ofasys_torch.utils.jax_params import export_params, load_jax_params

    net = _net(model)
    # reference keys name each layer: match them in the loop layout
    target = export_params(net, stacked=False)
    if "qkern" in target:
        raise ValueError("import_reference_state_dict: import before quantize()")
    used = set()
    missing: List[str] = []
    out: Dict[str, Any] = {}
    for p, leaf in _walk(target):
        mapped = flax_to_reference_key(p)
        new = None
        if mapped is not None:
            key, transform = mapped
            if transform == "rel_stack":
                L = leaf.shape[0]
                tables = []
                for i in range(L):
                    k = f"{key}.{i}.weight"
                    if k in state_dict:
                        tables.append(np.asarray(state_dict[k]))
                        used.add(k)
                if len(tables) == L:
                    new = np.stack(tables)
            elif key in state_dict:
                new = _to_flax(state_dict[key], transform, leaf.shape)
                used.add(key)
        if new is not None and tuple(new.shape) != tuple(leaf.shape):
            adapted = _adapt_vocab_axis(new, leaf)
            if adapted is not None:
                logger.warning("torch_import: vocab-axis repadded for %s: %s -> %s",
                               p, new.shape, np.asarray(leaf).shape)
                new = adapted
        if new is not None and tuple(new.shape) == tuple(leaf.shape):
            _put(out, p, new.astype(np.asarray(leaf).dtype))
        else:
            if mapped is not None:
                if new is not None:
                    logger.warning("torch_import: SKIPPED %s (shape %s vs target %s) — keeping "
                                   "the model's values", p, new.shape, np.asarray(leaf).shape)
                missing.append(p)
            _put(out, p, leaf)
    unused = [k for k in state_dict if k not in used]
    if strict and missing:
        raise KeyError(f"missing {len(missing)} params, e.g. {missing[:5]}")
    load_jax_params(net, out)
    return model, missing, unused


def export_reference_state_dict(model) -> Dict[str, np.ndarray]:
    """The inverse: a GeneralistModel, its net, or a flax-path param tree
    -> a reference-named state_dict of numpy arrays."""
    from ofasys_torch.utils.jax_params import export_params, unstack_layers

    if isinstance(model, dict):
        tree = unstack_layers(model)
    else:
        tree = export_params(_net(model), stacked=False)
    out: Dict[str, np.ndarray] = {}
    for p, leaf in _walk(tree):
        mapped = flax_to_reference_key(p)
        if mapped is None:
            continue
        key, transform = mapped
        v = np.asarray(leaf)
        if transform == "linear":
            # 4D HWIO -> torch OIHW by the conv permutation
            out[key] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        elif transform == "conv":
            out[key] = v.transpose(3, 2, 0, 1)
        elif transform == "row":
            out[key] = v[None]
        elif transform == "rel_stack":
            for i in range(v.shape[0]):
                out[f"{key}.{i}.weight"] = v[i]
        else:
            out[key] = v
    return out


def taming_to_flax_params(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A taming-transformers GumbelVQ state_dict (the released
    vqgan_gumbel_f8_8192 checkpoint) as model/vqgan.py's flax-path tree.

    Names: taming's ModuleList indices (down.{i}.block.{j}) become flat
    module names (down_{i}_block_{j}); quantize.proj -> quant_proj,
    quantize.embed -> codebook, post_quant_conv -> post_quant_proj; the
    loss, temperature and ``used`` entries are left out. Layouts: conv OIHW
    -> HWIO, GroupNorm weight -> scale."""
    out: Dict[str, Any] = {}
    for key, raw in sd.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if k.startswith("loss.") or k.endswith(("temperature", "used")):
            continue
        v = np.asarray(raw)
        if k == "quantize.embed.weight":
            _put(out, "codebook/embedding", v)
            continue
        k = (k.replace("quantize.proj", "quant_proj")
             .replace("post_quant_conv", "post_quant_proj")
             .replace("mid.block_1", "mid_block_1")
             .replace("mid.block_2", "mid_block_2")
             .replace("mid.attn_1", "mid_attn"))
        k = re.sub(r"(down|up)\.(\d+)\.(block|attn)\.(\d+)", r"\1_\2_\3_\4", k)
        k = re.sub(r"(down|up)\.(\d+)\.(downsample|upsample)\.conv", r"\1_\2_\3", k)
        name, leaf = k.rsplit(".", 1)
        path = name.replace(".", "/")
        if leaf == "weight":
            if v.ndim == 4:
                _put(out, f"{path}/kernel", v.transpose(2, 3, 1, 0))
            elif v.ndim == 1:                   # GroupNorm affine
                _put(out, f"{path}/scale", v)
            else:
                _put(out, f"{path}/kernel", v.T)
        elif leaf == "bias":
            _put(out, f"{path}/bias", v)
        else:
            logger.warning("taming_to_flax_params: skipping %s", key)
    return out


def hifigan_to_flax_params(sd: Dict[str, np.ndarray], num_kernels: int = 3) -> Dict[str, Any]:
    """A HiFi-GAN V1 generator state_dict (the released vocoder, reference
    module/hifigan.py:115-172) as model/hifigan.py's flax-path tree.

    Released checkpoints keep weight_norm unfused (``weight_g`` /
    ``weight_v``): w = g * v / ||v||, the norm over every axis but 0 (torch
    weight_norm's dim=0). Conv1d (O, I, k) -> flax (k, I, O);
    ConvTranspose1d (I, O, k) -> flax (k, I, O) flipped along k (flax
    correlates where torch's transposed convolution convolves). The
    reference's flat ``resblocks`` index n splits into (upsample level
    n // num_kernels, kernel branch n % num_kernels)."""
    fused: Dict[str, np.ndarray] = {}
    for key, raw in sd.items():
        v = np.asarray(raw)
        if key.endswith(".weight_v"):
            g = np.asarray(sd[key[: -len("_v")] + "_g"])
            norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1))
            fused[key[: -len(".weight_v")] + ".weight"] = v * (
                g.reshape(-1) / np.maximum(norm, 1e-12)).reshape((-1,) + (1,) * (v.ndim - 1))
        elif not key.endswith(".weight_g"):
            fused[key] = v

    out: Dict[str, Any] = {}
    for key, v in fused.items():
        k = key[len("generator."):] if key.startswith("generator.") else key
        m = re.match(r"resblocks\.(\d+)\.(convs[12])\.(\d+)\.(weight|bias)", k)
        if m:
            n, sub, j, leaf = int(m.group(1)), m.group(2), m.group(3), m.group(4)
            path = f"resblocks_{n // num_kernels}_{n % num_kernels}/{sub}_{j}"
        else:
            m = re.match(r"(conv_pre|conv_post|ups\.(\d+))\.(weight|bias)", k)
            if not m:
                logger.warning("hifigan_to_flax_params: skipping %s", key)
                continue
            leaf = m.group(3)
            path = f"ups_{m.group(2)}" if m.group(2) is not None else m.group(1)
        if leaf == "bias":
            _put(out, f"{path}/bias", v)
        elif path.startswith("ups_"):
            _put(out, f"{path}/kernel", v.transpose(2, 0, 1)[::-1].copy())
        else:
            _put(out, f"{path}/kernel", v.transpose(2, 1, 0))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch .pt checkpoint as a numpy state_dict on the host: its
    ``model``, ``state_dict`` or ``generator`` entry, or the bare dict.
    ``weights_only=False``: fairseq checkpoints pickle an args namespace."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state.get("model", state.get("state_dict", state.get("generator", state)))
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def _flax_shapes(net: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Flax path -> shape of each parameter of ``net`` (any device, ``meta``
    included: no data is read), named as ``export_params`` names them."""
    from ofasys_torch.utils.checkpoint_utils import _flax_leaf

    out = {}
    for name, p in net.named_parameters():
        leaf = _flax_leaf(net, name)
        linear = leaf == "kernel" and name.rsplit(".", 1)[-1] == "weight"    # a Linear's, transposed
        out["/".join(name.split(".")[:-1] + [leaf])] = tuple(p.shape)[::-1] if linear else tuple(p.shape)
    return out


def check_converted_params(converted: Dict[str, Any], net: nn.Module, name: str) -> None:
    """Hold a converted checkpoint tree against the parameters ``net``
    expects, by shape only (build ``net`` on the ``meta`` device: no
    memory, no FLOPs). Raises on missing or shape-mismatched leaves, warns
    on unconsumed ones, so a wrong or truncated checkpoint fails at load
    time with names."""
    exp_flat = _flax_shapes(net)
    got_flat = {p: tuple(np.shape(v)) for p, v in _walk(converted)}
    missing = sorted(set(exp_flat) - set(got_flat))
    unconsumed = sorted(set(got_flat) - set(exp_flat))
    mismatched = sorted(
        f"{k}: ckpt {got_flat[k]} vs model {exp_flat[k]}"
        for k in set(exp_flat) & set(got_flat)
        if tuple(got_flat[k]) != tuple(exp_flat[k])
    )
    if missing or mismatched:
        raise ValueError(
            f"{name}: converted checkpoint does not match the model — "
            f"missing leaves: {missing[:10]}{'...' if len(missing) > 10 else ''}; "
            f"shape mismatches: {mismatched[:10]}{'...' if len(mismatched) > 10 else ''}"
        )
    if unconsumed:
        logger.warning("%s: %d unconsumed checkpoint leaves: %s%s", name,
                       len(unconsumed), unconsumed[:10],
                       "..." if len(unconsumed) > 10 else "")


# ------------------------------------------------------------------- CLI
def main(argv=None):
    """Convert a reference torch checkpoint into one the hub loads:

        python -m ofasys_torch.utils.torch_import ref.pt out_dir \\
            --arch base --adaptors text,image_resnet [--dict vocab.txt] [--device cpu]

    Without --dict the vocabulary is sized from the checkpoint's token
    embedding and filled with placeholder symbols: token ids line up, but
    readable symbols need the original vocabulary file. The output
    directory loads with ``OFASys.from_pretrained(out_dir + '/checkpoint_last')``.
    The model is built on ``--device`` (default cuda; raises without a card
    unless --device cpu is given).
    """
    import argparse

    ap = argparse.ArgumentParser(
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt", help="reference .pt checkpoint")
    ap.add_argument("out_dir", help="output checkpoint directory")
    ap.add_argument("--arch", default="base")
    ap.add_argument("--adaptors", default="text",
                    help="comma list, e.g. text,image_resnet,audio_fbank")
    ap.add_argument("--dict", dest="dict_path", default=None,
                    help="vocabulary file (Dictionary.load format)")
    ap.add_argument("--preprocessors", default="text",
                    help="comma list whose special symbols register into "
                         "the dictionary before the model is sized")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any unmapped model parameter")
    ap.add_argument("--device", default="cuda", help="where the model is built (cuda or cpu)")
    args = ap.parse_args(argv)

    from ofasys_torch.configure import to_dict
    from ofasys_torch.model.ofa import GeneralistModel
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess
    from ofasys_torch.utils import checkpoint_utils

    sd = load_torch_checkpoint(args.ckpt)
    preprocessors = [p.strip() for p in args.preprocessors.split(",") if p.strip()]
    if args.dict_path:
        with open(args.dict_path) as f:
            d = Dictionary.load(f)
        GeneralPreprocess(d, active=preprocessors)
    else:
        embed_key = "encoder.adaptor.embed_tokens.weight"
        if embed_key not in sd:
            raise SystemExit(
                f"--dict not given and {embed_key!r} not in the checkpoint; "
                "cannot infer vocabulary size")
        vocab = int(sd[embed_key].shape[0])
        d = Dictionary()
        # the preprocessors register their special symbols first, as the
        # trainer does and as from_pretrained assumes of the saved dictionary
        GeneralPreprocess(d, active=preprocessors)
        i = 0
        while len(d) < vocab:
            d.add_symbol(f"<imported>_{i}")
            i += 1
        if len(d) > vocab:
            logger.warning(
                "dictionary (%d) exceeds checkpoint vocab (%d) after "
                "preprocessor symbols — embedding rows will be repadded",
                len(d), vocab)
        logger.warning("vocabulary inferred from checkpoint: placeholder "
                       "symbols — supply --dict for readable tokens")

    adaptors = tuple(a.strip() for a in args.adaptors.split(",") if a.strip())
    model = GeneralistModel(arch=args.arch)
    model.cfg.dropout = 0.0
    model.initialize(d, active_adaptors=adaptors, dtype=torch.float32, device=args.device)
    model, missing, unused = import_reference_state_dict(sd, model, strict=args.strict)
    print(f"imported: {sum(1 for _ in model.net.parameters())} leaves, "
          f"{len(missing)} left at random init, "
          f"{len(unused)} checkpoint keys unused")
    if missing:
        print("  random-init (first 10):", missing[:10])

    meta = {
        "num_updates": 0,
        "configstore": {},
        "global_dict": d.state_dict(),
        "model_cfg": to_dict(model.cfg),
        "active_adaptors": list(adaptors),
    }
    checkpoint_utils.save_checkpoint(
        args.out_dir, "checkpoint_last",
        {"params": checkpoint_utils.flax_tree(model.net), "step": 0}, meta=meta)
    print(f"wrote {args.out_dir}/checkpoint_last "
          f"(load with OFASys.from_pretrained)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
