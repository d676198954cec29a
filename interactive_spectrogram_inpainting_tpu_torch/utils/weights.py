"""Flax parameter trees -> PyTorch ``state_dict``s, and flax-like init.

``from_flax_params`` takes a JAX package variables tree whose leaves are
numpy arrays (``jax.tree_util.tree_map(np.asarray, variables)``) and returns
the ``state_dict`` of the matching port module, so both packages compute
the same function:

- Dense kernels ``[in, out]`` become ``nn.Linear`` weights ``[out, in]``;
  ``DenseGeneral`` q/k/v kernels ``[d, H, Dh]`` and o kernels ``[H, Dh, d]``
  flatten the head axes first;
- Conv kernels HWIO become OIHW; LayerNorm and GroupNorm ``scale`` become
  ``weight``;
- ConvTranspose kernels ``[kH, kW, I, O]`` (flax, ``padding='SAME'``)
  become ``nn.ConvTranspose2d`` weights ``[I, O, kH, kW]`` with both
  spatial axes flipped (flax's transposed conv correlates, PyTorch's
  convolves);
- the VQ-VAE codebooks and their EMA state (``embed``, ``cluster_size``,
  ``embed_avg``) come from the ``codebook`` collection.

``to_flax_params`` is the inverse: a port module's weights as the JAX
package's variables tree (numpy leaves), which ``utils/checkpoint_io.py``
writes into the JAX package's checkpoint files.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _dense(sd: Dict, prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _dense_heads_in(sd: Dict, prefix: str, node: Mapping) -> None:
    """DenseGeneral d -> (H, Dh)."""
    kernel = np.asarray(node["kernel"])
    d = kernel.shape[0]
    sd[f"{prefix}.weight"] = _t(kernel.reshape(d, -1).T)
    sd[f"{prefix}.bias"] = _t(np.asarray(node["bias"]).reshape(-1))


def _dense_heads_out(sd: Dict, prefix: str, node: Mapping) -> None:
    """DenseGeneral (H, Dh) -> d."""
    kernel = np.asarray(node["kernel"])
    d = kernel.shape[-1]
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, d).T)
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _ln(sd: Dict, prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _mha(sd: Dict, prefix: str, node: Mapping) -> None:
    for name in ("q", "k", "v"):
        _dense_heads_in(sd, f"{prefix}.{name}", node[name])
    _dense_heads_out(sd, f"{prefix}.o", node["o"])


def _mlp(sd: Dict, prefix: str, node: Mapping) -> None:
    _dense(sd, f"{prefix}.fc1", node["Dense_0"])
    _dense(sd, f"{prefix}.fc2", node["Dense_1"])


def _prior_state_dict(p: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name in ("source_embed", "target_embed"):
        sd[f"{name}.weight"] = _t(p[name]["embedding"])
    for name in ("source_embeddings_linear", "target_embeddings_linear",
                 "project_logits"):
        _dense(sd, name, p[name])
    for name in ("source_pos_frequency", "target_pos_frequency",
                 "target_pos_patch", "source_start_symbol",
                 "target_start_symbol"):
        sd[name] = _t(p[name])
    for key, node in p.items():
        if key.startswith("class_conditioning_"):
            modality = key[len("class_conditioning_"):]
            sd[f"class_embeds.{modality}.weight"] = _t(node["embedding"])
    i = 0
    while f"encoder_layer_{i}" in p:
        node = p[f"encoder_layer_{i}"]
        pre = f"encoder_layers.{i}"
        sd[f"{pre}.self_bias.rel_bias"] = _t(node["self_bias"]["rel_bias"])
        _mha(sd, f"{pre}.self_attn", node["self_attn"])
        _ln(sd, f"{pre}.ln1", node["ln1"])
        _ln(sd, f"{pre}.ln2", node["ln2"])
        _mlp(sd, f"{pre}.mlp", node["mlp"])
        i += 1
    _ln(sd, "encoder_norm", p["encoder_norm"])
    i = 0
    while f"decoder_layer_{i}" in p:
        node = p[f"decoder_layer_{i}"]
        pre = f"decoder_layers.{i}"
        sd[f"{pre}.self_bias.rel_bias"] = _t(node["self_bias"]["rel_bias"])
        if "cross_bias" in node:
            sd[f"{pre}.cross_bias.rel_bias"] = _t(
                node["cross_bias"]["rel_bias"])
        _mha(sd, f"{pre}.self_attn", node["self_attn"])
        _mha(sd, f"{pre}.cross_attn", node["cross_attn"])
        for ln in ("ln1", "ln2", "ln3"):
            _ln(sd, f"{pre}.{ln}", node[ln])
        _mlp(sd, f"{pre}.mlp", node["mlp"])
        i += 1
    _ln(sd, "decoder_norm", p["decoder_norm"])
    return sd


def conv_from_flax(kernel) -> torch.Tensor:
    """flax Conv kernel [kH, kW, I/g, O] -> torch Conv2d weight [O, I/g, kH, kW]."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def conv_transpose_from_flax(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel [kH, kW, I, O] -> torch ConvTranspose2d
    weight [I, O, kH, kW], spatially flipped."""
    w = np.transpose(np.asarray(kernel), (2, 3, 0, 1))
    return _t(w[:, :, ::-1, ::-1])


def _conv(sd: Dict, prefix: str, node: Mapping, transpose: bool = False):
    sd[f"{prefix}.weight"] = (conv_transpose_from_flax(node["kernel"])
                              if transpose else conv_from_flax(node["kernel"]))
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _decoder_state_dict(sd: Dict, prefix: str, node: Mapping) -> None:
    _conv(sd, f"{prefix}.conv_in", node["Conv_0"])
    r = 0
    while f"ResBlock_{r}" in node:
        res = node[f"ResBlock_{r}"]
        _conv(sd, f"{prefix}.res_blocks.{r}.conv1", res["Conv_0"])
        _conv(sd, f"{prefix}.res_blocks.{r}.conv2", res["Conv_1"])
        r += 1
    i = 0
    while f"ConvTranspose_{i}" in node:
        _conv(sd, f"{prefix}.upsample.{i}", node[f"ConvTranspose_{i}"],
              transpose=True)
        i += 1


def _encoder_state_dict(sd: Dict, prefix: str, node: Mapping) -> None:
    """flax numbers an Encoder's convs in call order: the strided
    downsampling convs, then the trailing 3x3."""
    n_convs = sum(1 for key in node if key.startswith("Conv_"))
    for i in range(n_convs - 1):
        _conv(sd, f"{prefix}.downsample.{i}", node[f"Conv_{i}"])
    _conv(sd, f"{prefix}.conv_out", node[f"Conv_{n_convs - 1}"])
    r = 0
    while f"ResBlock_{r}" in node:
        res = node[f"ResBlock_{r}"]
        _conv(sd, f"{prefix}.res_blocks.{r}.conv1", res["Conv_0"])
        _conv(sd, f"{prefix}.res_blocks.{r}.conv2", res["Conv_1"])
        r += 1


def _n_convs(node: Mapping) -> int:
    return sum(1 for key in node if key.startswith("Conv_"))


def _resnet_encoder_state_dict(sd: Dict, prefix: str, node: Mapping) -> None:
    """``XResNetEncoder``: the stem convs, then the residual blocks, then the
    1x1 output conv (flax numbers the convs in call order)."""
    n_convs = _n_convs(node)
    for i in range(n_convs - 1):
        _conv(sd, f"{prefix}.stem.{i}", node[f"Conv_{i}"])
    _conv(sd, f"{prefix}.conv_out", node[f"Conv_{n_convs - 1}"])
    r = 0
    while f"ResNetBlock_{r}" in node:
        block, pre = node[f"ResNetBlock_{r}"], f"{prefix}.blocks.{r}"
        for i in (0, 1):
            sd[f"{pre}.norm{i + 1}.weight"] = _t(
                block[f"GroupNorm_{i}"]["scale"])
            sd[f"{pre}.norm{i + 1}.bias"] = _t(
                block[f"GroupNorm_{i}"]["bias"])
            _conv(sd, f"{pre}.conv{i + 1}", block[f"Conv_{i}"])
        if "Conv_2" in block:
            _conv(sd, f"{pre}.shortcut", block["Conv_2"])
        r += 1


def _resnet_decoder_state_dict(sd: Dict, prefix: str, node: Mapping) -> None:
    """``NoSkipUnetDecoder``: three convs per stage, then the output conv."""
    n_convs = _n_convs(node)
    for i in range(n_convs - 1):
        _conv(sd, f"{prefix}.convs.{i}", node[f"Conv_{i}"])
    _conv(sd, f"{prefix}.conv_out", node[f"Conv_{n_convs - 1}"])


def _vqvae_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    # the transposed-conv decoder always upsamples; the ResNet one never
    # has a ConvTranspose
    resnet = "ConvTranspose_0" not in p["dec"]
    encoder = _resnet_encoder_state_dict if resnet else _encoder_state_dict
    decoder = _resnet_decoder_state_dict if resnet else _decoder_state_dict
    encoder(sd, "enc_b", p["enc_b"])
    encoder(sd, "enc_t", p["enc_t"])
    _conv(sd, "quantize_conv_t", p["quantize_conv_t"])
    _conv(sd, "quantize_conv_b", p["quantize_conv_b"])
    decoder(sd, "dec_t", p["dec_t"])
    decoder(sd, "dec", p["dec"])
    ups = p["upsample_top_to_bottom"]
    i = 0
    while f"ConvTranspose_{i}" in ups:
        _conv(sd, f"upsample_top_to_bottom.layers.{i}",
              ups[f"ConvTranspose_{i}"], transpose=True)
        i += 1
    for level, buffers in variables["codebook"].items():
        for name in ("embed", "cluster_size", "embed_avg"):
            sd[f"{level}.{name}"] = _t(buffers[name])
    return sd


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX package variables (numpy leaves) -> port ``state_dict``.

    Accepts a prior's or the VQ-VAE's variables (``{'params': ...}``, plus
    ``'codebook'`` for the VQ-VAE) or a prior's bare params tree."""
    if "codebook" in tree:
        return _vqvae_state_dict(tree)
    params = tree["params"] if "params" in tree else tree
    if "decoder_layer_0" not in params:
        raise ValueError("not a prior or VQ-VAE parameter tree")
    return _prior_state_dict(params)


# -- the inverse: port modules -> flax trees -----------------------------------

def _n(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().float().numpy())


def _dense_node(sd: Mapping, prefix: str) -> Dict:
    return {"kernel": _n(sd[f"{prefix}.weight"].T),
            "bias": _n(sd[f"{prefix}.bias"])}


def _mha_node(sd: Mapping, prefix: str, n_heads: int) -> Dict:
    node = {}
    for name in ("q", "k", "v"):
        w = _n(sd[f"{prefix}.{name}.weight"])  # [H * Dh, d]
        node[name] = {"kernel": np.ascontiguousarray(w.T).reshape(
                          w.shape[1], n_heads, -1),
                      "bias": _n(sd[f"{prefix}.{name}.bias"]).reshape(
                          n_heads, -1)}
    w = _n(sd[f"{prefix}.o.weight"])  # [d, H * Dh]
    node["o"] = {"kernel": np.ascontiguousarray(w.T).reshape(
                     n_heads, -1, w.shape[0]),
                 "bias": _n(sd[f"{prefix}.o.bias"])}
    return node


def _ln_node(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _n(sd[f"{prefix}.weight"]),
            "bias": _n(sd[f"{prefix}.bias"])}


def _prior_tree(sd: Mapping, n_heads: int) -> Dict:
    p: Dict[str, Any] = {}
    for name in ("source_embed", "target_embed"):
        p[name] = {"embedding": _n(sd[f"{name}.weight"])}
    for name in ("source_embeddings_linear", "target_embeddings_linear",
                 "project_logits"):
        p[name] = _dense_node(sd, name)
    for name in ("source_pos_frequency", "target_pos_frequency",
                 "target_pos_patch", "source_start_symbol",
                 "target_start_symbol"):
        p[name] = _n(sd[name])
    for key in sd:
        if key.startswith("class_embeds."):
            modality = key[len("class_embeds."):-len(".weight")]
            p[f"class_conditioning_{modality}"] = {"embedding": _n(sd[key])}
    for kind in ("encoder", "decoder"):
        i = 0
        while f"{kind}_layers.{i}.ln1.weight" in sd:
            pre = f"{kind}_layers.{i}"
            node = {"self_bias": {"rel_bias": _n(
                        sd[f"{pre}.self_bias.rel_bias"])},
                    "self_attn": _mha_node(sd, f"{pre}.self_attn", n_heads),
                    "ln1": _ln_node(sd, f"{pre}.ln1"),
                    "ln2": _ln_node(sd, f"{pre}.ln2"),
                    "mlp": {"Dense_0": _dense_node(sd, f"{pre}.mlp.fc1"),
                            "Dense_1": _dense_node(sd, f"{pre}.mlp.fc2")}}
            if kind == "decoder":
                if f"{pre}.cross_bias.rel_bias" in sd:
                    node["cross_bias"] = {"rel_bias": _n(
                        sd[f"{pre}.cross_bias.rel_bias"])}
                node["cross_attn"] = _mha_node(sd, f"{pre}.cross_attn",
                                               n_heads)
                node["ln3"] = _ln_node(sd, f"{pre}.ln3")
            p[f"{kind}_layer_{i}"] = node
            i += 1
        p[f"{kind}_norm"] = _ln_node(sd, f"{kind}_norm")
    return p


def _conv_node(sd: Mapping, prefix: str, transpose: bool = False) -> Dict:
    w = _n(sd[f"{prefix}.weight"])
    if transpose:  # [I, O, kH, kW] flipped -> [kH, kW, I, O]
        kernel = np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))
    else:          # [O, I/g, kH, kW] -> [kH, kW, I/g, O]
        kernel = np.transpose(w, (2, 3, 1, 0))
    return {"kernel": np.ascontiguousarray(kernel),
            "bias": _n(sd[f"{prefix}.bias"])}


def _res_nodes(sd: Mapping, prefix: str, node: Dict) -> None:
    r = 0
    while f"{prefix}.res_blocks.{r}.conv1.weight" in sd:
        node[f"ResBlock_{r}"] = {
            "Conv_0": _conv_node(sd, f"{prefix}.res_blocks.{r}.conv1"),
            "Conv_1": _conv_node(sd, f"{prefix}.res_blocks.{r}.conv2")}
        r += 1


def _encoder_node(sd: Mapping, prefix: str) -> Dict:
    node: Dict[str, Any] = {}
    i = 0
    while f"{prefix}.downsample.{i}.weight" in sd:
        node[f"Conv_{i}"] = _conv_node(sd, f"{prefix}.downsample.{i}")
        i += 1
    node[f"Conv_{i}"] = _conv_node(sd, f"{prefix}.conv_out")
    _res_nodes(sd, prefix, node)
    return node


def _upsample_nodes(sd: Mapping, prefix: str, node: Dict) -> None:
    i = 0
    while f"{prefix}.{i}.weight" in sd:
        node[f"ConvTranspose_{i}"] = _conv_node(sd, f"{prefix}.{i}",
                                                transpose=True)
        i += 1


def _decoder_node(sd: Mapping, prefix: str) -> Dict:
    node = {"Conv_0": _conv_node(sd, f"{prefix}.conv_in")}
    _res_nodes(sd, prefix, node)
    _upsample_nodes(sd, f"{prefix}.upsample", node)
    return node


def _numbered_convs(sd: Mapping, prefix: str, node: Dict) -> int:
    i = 0
    while f"{prefix}.{i}.weight" in sd:
        node[f"Conv_{i}"] = _conv_node(sd, f"{prefix}.{i}")
        i += 1
    return i


def _resnet_encoder_node(sd: Mapping, prefix: str) -> Dict:
    node: Dict[str, Any] = {}
    n = _numbered_convs(sd, f"{prefix}.stem", node)
    node[f"Conv_{n}"] = _conv_node(sd, f"{prefix}.conv_out")
    r = 0
    while f"{prefix}.blocks.{r}.conv1.weight" in sd:
        pre = f"{prefix}.blocks.{r}"
        block = {}
        for i in (0, 1):
            block[f"GroupNorm_{i}"] = {
                "scale": _n(sd[f"{pre}.norm{i + 1}.weight"]),
                "bias": _n(sd[f"{pre}.norm{i + 1}.bias"])}
            block[f"Conv_{i}"] = _conv_node(sd, f"{pre}.conv{i + 1}")
        if f"{pre}.shortcut.weight" in sd:
            block["Conv_2"] = _conv_node(sd, f"{pre}.shortcut")
        node[f"ResNetBlock_{r}"] = block
        r += 1
    return node


def _resnet_decoder_node(sd: Mapping, prefix: str) -> Dict:
    node: Dict[str, Any] = {}
    n = _numbered_convs(sd, f"{prefix}.convs", node)
    node[f"Conv_{n}"] = _conv_node(sd, f"{prefix}.conv_out")
    return node


def _vqvae_tree(sd: Mapping) -> Dict:
    ups: Dict[str, Any] = {}
    _upsample_nodes(sd, "upsample_top_to_bottom.layers", ups)
    resnet = "enc_b.stem.0.weight" in sd
    encoder = _resnet_encoder_node if resnet else _encoder_node
    decoder = _resnet_decoder_node if resnet else _decoder_node
    params = {"enc_b": encoder(sd, "enc_b"),
              "enc_t": encoder(sd, "enc_t"),
              "quantize_conv_t": _conv_node(sd, "quantize_conv_t"),
              "quantize_conv_b": _conv_node(sd, "quantize_conv_b"),
              "dec_t": decoder(sd, "dec_t"),
              "dec": decoder(sd, "dec"),
              "upsample_top_to_bottom": ups}
    codebook = {
        level: {name: _n(sd[f"{level}.{name}"])
                for name in ("embed", "cluster_size", "embed_avg")}
        for level in ("quantize_t", "quantize_b")
        if f"{level}.embed" in sd}
    return {"params": params, "codebook": codebook}


def to_flax_params(module: nn.Module,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
    """A port VQ-VAE's or prior's weights (or ``state_dict`` for it) as the
    JAX package's variables tree with numpy leaves: the inverse of
    ``from_flax_params``."""
    sd = module.state_dict() if state_dict is None else state_dict
    if "quantize_conv_t.weight" in sd:
        return _vqvae_tree(sd)
    if "decoder_norm.weight" not in sd:
        raise ValueError("not a prior or VQ-VAE module")
    return {"params": _prior_tree(
        sd, int(module.config.conditional_model_nhead))}


# -- flax-like random initialization ------------------------------------------

def init_like_flax(module: nn.Module,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw a port module's parameters with the JAX package's flax
    initializers' scales (lecun-normal kernels, zero biases, unit-variance
    embeddings and positional tables, 0.02 relative-bias tables, codebooks
    at their configured variance), so randomly initialized test models see
    realistic activations and depend on ``generator`` alone."""
    from ..models.prior.attention import RelativeAttentionBias
    from ..models.vqvae.bottleneck import QuantizedBottleneck

    def normal_(t: torch.Tensor, std: float) -> None:
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            normal_(sub.weight, 1.0 / math.sqrt(sub.in_features))
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.Embedding):
            normal_(sub.weight, 1.0 / math.sqrt(sub.embedding_dim))
        elif isinstance(sub, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.ConvTranspose2d):
            i, _, kh, kw = sub.weight.shape
            normal_(sub.weight, 1.0 / math.sqrt(i * kh * kw))
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.Conv2d):
            _, i, kh, kw = sub.weight.shape
            normal_(sub.weight, 1.0 / math.sqrt(i * kh * kw))
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, RelativeAttentionBias):
            normal_(sub.rel_bias, 0.02)
        elif isinstance(sub, QuantizedBottleneck):
            normal_(sub.embed, sub.embeddings_initial_variance ** 0.5)
            sub.embed_avg.copy_(sub.embed)
            sub.cluster_size.zero_()
    for name, param in module.named_parameters(recurse=True):
        if name.endswith(("_pos_frequency", "pos_patch", "start_symbol")):
            normal_(param, 1.0)
    return module
