"""Plain reference of the two relative-attention priors (the NOTONO top and
bottom priors), written from their published description in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
parameters come as a plain ``{name: tensor}`` dict that the benchmark draws
from the seed (``parameter_spec`` gives the names, shapes and scales; the
names are those of the program's ``state_dict``, so one dict loads both).

The model (pre-LN transformer, LayerNorm epsilon 1e-6):

- a codemap [F, T] is read frequency first: sequence position ``j`` holds
  cell ``(j % F, j // F)``; the bottom prior reads its codemap in patches
  of ``(pf, pt)`` cells, one patch per top cell in the top's order, each
  patch frequency first;
- a token's input is ``Linear(Embedding(token))`` beside its positional
  features (a learned row per frequency, and per cell of a patch on the
  target side); start symbols lead each sequence, their first dims
  overwritten by the concatenated class embeddings (pitch, family);
- the top prior's source is its own codemap with the masked cells
  replaced by an extra mask token, read by an anti-causal encoder; the
  bottom prior's source is the top codemap, read without a mask;
- relative attention bias ``table[h, c_q, c_k, clip(e_q - e_k + E_k - 1)]``
  with ``e = i // C``, ``c = i % C`` (``C`` the channels, one patch);
- the decoder is causal, with cross attention to the encoder's memory
  (the bottom prior's is aligned: a query sees only the source position of
  its own patch); its last state before position ``i`` predicts token
  ``i``;
- dropout (training) after each attention and after the feed-forward's
  ReLU, with the masks drawn as ``dropout_generators`` sets out.

``Precision`` rounds the inputs of every product: the identity for the
float32 reference, float8 e4m3 for the serving control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
LN_EPS = 1e-6


class Geometry:
    """The derived sizes of one prior, from its configuration dict (the
    keys of ``configs/*.json``)."""

    def __init__(self, cfg: dict):
        self.self_conditional = bool(cfg.get("self_conditional_model", False))
        self.shape = tuple(cfg["shape"])
        self.condition_shape = (self.shape if self.self_conditional
                                else tuple(cfg["condition_shape"]))
        if cfg.get("positional_class_conditioning", False):
            raise ValueError("the reference covers class conditioning in "
                             "the start symbols only")
        if not cfg.get("class_conditioning_prepend_to_dummy_input", False):
            raise ValueError("the reference covers class embeddings "
                             "prepended to the start symbols only")
        if cfg.get("use_identity_memory_mask", False):
            raise ValueError("the reference covers relative-bias cross "
                             "attention only")
        self.n_class = int(cfg["n_class"])
        self.d = int(cfg["d_model"])
        self.emb = int(cfg["embeddings_dim"])
        self.pos = 2 * (int(cfg["positional_embeddings_dim"]) // 2)
        self.heads = int(cfg["conditional_model_nhead"])
        self.n_enc = int(cfg["conditional_model_num_encoder_layers"])
        self.n_dec = int(cfg["conditional_model_num_decoder_layers"])
        self.d_ff = int(cfg["d_ff"])
        self.dropout = float(cfg.get("dropout", 0.0))
        self.aligned = bool(cfg.get("use_aligned_decoder", False))
        self.modalities = dict(cfg["class_conditioning_num_classes_per_modality"])
        self.modality_dims = dict(
            cfg["class_conditioning_embedding_dim_per_modality"])
        self.f_t, self.t_t = self.shape
        self.f_s, self.t_s = self.condition_shape
        self.pf = self.f_t // self.f_s
        self.pt = self.t_t // self.t_s
        self.channels = self.pf * self.pt
        self.l_t = self.f_t * self.t_t
        self.l_s = self.f_s * self.t_s
        self.events_t = self.l_t // self.channels
        self.n_class_source = self.n_class + int(self.self_conditional)
        self.eff = self.d - self.pos
        self.class_dim = sum(self.modality_dims.values())


def parameter_spec(g: Geometry) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter; init is ('normal', std),
    ('zeros',) or ('ones',): lecun-normal kernels, unit-variance
    embeddings, positional rows and start symbols, 0.02 bias tables."""
    spec = []

    def linear(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in),
                     ("normal", 1.0 / math.sqrt(n_in))))
        spec.append((f"{name}.bias", (n_out,), ("zeros",)))

    def norm(name):
        spec.append((f"{name}.weight", (g.d,), ("ones",)))
        spec.append((f"{name}.bias", (g.d,), ("zeros",)))

    def attention(name):
        for part in ("q", "k", "v", "o"):
            linear(f"{name}.{part}", g.d, g.d)

    spec.append(("source_embed.weight", (g.n_class_source, g.emb),
                 ("normal", 1.0 / math.sqrt(g.emb))))
    linear("source_embeddings_linear", g.emb, g.eff)
    spec.append(("target_embed.weight", (g.n_class, g.emb),
                 ("normal", 1.0 / math.sqrt(g.emb))))
    linear("target_embeddings_linear", g.emb, g.eff)
    linear("project_logits", g.d, g.n_class)
    half = g.pos // 2
    spec.append(("source_pos_frequency", (g.f_s, half), ("normal", 1.0)))
    spec.append(("target_pos_frequency", (g.f_t, half), ("normal", 1.0)))
    spec.append(("target_pos_patch", (g.pf, g.pt, half), ("normal", 1.0)))
    spec.append(("source_start_symbol", (1, g.d), ("normal", 1.0)))
    spec.append(("target_start_symbol", (g.channels, g.d), ("normal", 1.0)))
    for name, num in g.modalities.items():
        dim = g.modality_dims[name]
        spec.append((f"class_embeds.{name}.weight", (num, dim),
                     ("normal", 1.0 / math.sqrt(dim))))
    src_events = g.l_s + 1
    tgt_events = g.events_t + 1
    for i in range(g.n_enc):
        pre = f"encoder_layers.{i}"
        spec.append((f"{pre}.self_bias.rel_bias",
                     (g.heads, 1, 1, 2 * src_events - 1), ("normal", 0.02)))
        attention(f"{pre}.self_attn")
        norm(f"{pre}.ln1")
        norm(f"{pre}.ln2")
        linear(f"{pre}.mlp.fc1", g.d, g.d_ff)
        linear(f"{pre}.mlp.fc2", g.d_ff, g.d)
    norm("encoder_norm")
    for i in range(g.n_dec):
        pre = f"decoder_layers.{i}"
        spec.append((f"{pre}.self_bias.rel_bias",
                     (g.heads, g.channels, g.channels, 2 * tgt_events - 1),
                     ("normal", 0.02)))
        spec.append((f"{pre}.cross_bias.rel_bias",
                     (g.heads, g.channels, 1, tgt_events + src_events - 1),
                     ("normal", 0.02)))
        attention(f"{pre}.self_attn")
        attention(f"{pre}.cross_attn")
        for n in ("ln1", "ln2", "ln3"):
            norm(f"{pre}.{n}")
        linear(f"{pre}.mlp.fc1", g.d, g.d_ff)
        linear(f"{pre}.mlp.fc2", g.d_ff, g.d)
    norm("decoder_norm")
    return spec


# -- reading orders ------------------------------------------------------------

def frequency_first(f: int, t: int) -> np.ndarray:
    """Flat cell index (``f * T + t``) of each sequence position."""
    j = np.arange(f * t)
    return (j % f) * t + j // f


def patches_frequency_first(f: int, t: int, pf: int, pt: int) -> np.ndarray:
    """The bottom prior's order: patches in the top's order, cells of a
    patch frequency first."""
    j = np.arange(f * t)
    pf_i, rest = j % pf, j // pf
    pt_i, rest = rest % pt, rest // pt
    f_src = f // pf
    f_s, t_s = rest % f_src, rest // f_src
    return (f_s * pf + pf_i) * t + t_s * pt + pt_i


def target_order(g: Geometry) -> np.ndarray:
    if g.self_conditional:
        return frequency_first(g.f_t, g.t_t)
    return patches_frequency_first(g.f_t, g.t_t, g.pf, g.pt)


def to_sequence(codemap: torch.Tensor, order: np.ndarray) -> torch.Tensor:
    """[B, F, T(, E)] -> [B, F * T(, E)] in ``order``."""
    flat = codemap.reshape((codemap.shape[0], -1) + tuple(codemap.shape[3:]))
    return flat[:, torch.as_tensor(order, device=codemap.device)]


# -- products ------------------------------------------------------------------

def round_float8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale per tensor (its largest
    magnitude at the format's largest value, 448), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """Rounds both inputs of every product (``None``: exact float32)."""

    def __init__(self, rounding=None):
        self.rounding = rounding

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rounding is None else self.rounding(x)

    def linear(self, x, p, name):
        return F.linear(self.r(x), self.r(p[f"{name}.weight"]),
                        p[f"{name}.bias"])

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


EXACT = Precision()
FLOAT8 = Precision(round_float8)


def layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def bias_index(len_q, len_k, c_q, c_k, events_k, max_rel, device):
    """Flat index into a bias table [C_q, C_k, max_rel] of every
    (query, key) pair."""
    key = (len_q, len_k, c_q, c_k, events_k, max_rel, str(device))
    if key not in _INDEX_CACHE:
        iq = torch.arange(len_q, device=device)
        ik = torch.arange(len_k, device=device)
        e_q, ch_q = iq // c_q, iq % c_q
        e_k, ch_k = ik // c_k, ik % c_k
        rel = (e_q[:, None] - e_k[None, :] + events_k - 1).clamp(
            0, max_rel - 1)
        _INDEX_CACHE[key] = (ch_q[:, None] * c_k + ch_k[None, :]) * max_rel \
            + rel
    return _INDEX_CACHE[key]


def relative_bias(table, len_q, len_k, c_q, c_k, events_k):
    """[H, len_q, len_k] from a table [H, C_q, C_k, max_rel]."""
    heads, _, _, max_rel = table.shape
    idx = bias_index(len_q, len_k, c_q, c_k, events_k, max_rel, table.device)
    return table.reshape(heads, -1)[:, idx]


def attention(p, name, x_q, x_kv, heads, bias, mask, prec):
    b, lq, d = x_q.shape
    dh = d // heads
    q = prec.linear(x_q, p, f"{name}.q").reshape(b, lq, heads, dh)
    k = prec.linear(x_kv, p, f"{name}.k").reshape(b, -1, heads, dh)
    v = prec.linear(x_kv, p, f"{name}.v").reshape(b, -1, heads, dh)
    logits = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    logits = logits + bias[None]
    if mask is not None:
        logits = logits + mask[None, None]
    weights = torch.softmax(logits, dim=-1)
    out = prec.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, lq, d)
    return prec.linear(out, p, f"{name}.o")


def dropout(x, rate, gen):
    """``x * keep / (1 - rate)`` with ``keep`` drawn as Bernoulli(1 - rate)
    from ``gen`` in x's shape (None: the identity)."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(
        1.0 - rate, generator=gen)
    return x * keep / (1.0 - rate)


def dropout_generators(step_generator: torch.Generator, g: Geometry,
                       device) -> Tuple[list, list]:
    """The masks' generators of one training forward: one seed per encoder
    layer, then one per decoder layer, drawn from the step's generator as
    integers in [0, 2**62); each layer's generator on ``device`` seeded
    with its seed draws that layer's masks in the order the layer applies
    them (attention outputs, then the feed-forward's hidden units)."""
    def layer_generators(n):
        seeds = torch.randint(0, 2 ** 62, (n,), generator=step_generator,
                              device=step_generator.device)
        return [torch.Generator(device=device).manual_seed(int(s))
                for s in seeds.tolist()]
    return layer_generators(g.n_enc), layer_generators(g.n_dec)


# -- the model -----------------------------------------------------------------

def start_block(p, g, kind, labels, batch):
    start = p[f"{kind}_start_symbol"]
    start = start[None].expand((batch,) + tuple(start.shape))
    parts = [p[f"class_embeds.{name}.weight"][labels[name].reshape(batch)]
             for name in g.modalities]
    block = torch.cat(parts, dim=-1)
    block = block[:, None, :].expand(-1, start.shape[1], -1)
    return torch.cat([block, start[..., block.shape[-1]:]], dim=-1)


def positional_rows(p, g, kind) -> torch.Tensor:
    """[L, P] positional features in reading order."""
    if kind == "source":
        freq = p["source_pos_frequency"]
        rep = freq[:, None, :].expand(-1, g.t_s, -1)
        grid = torch.cat([rep, rep], dim=-1)
        order = frequency_first(g.f_s, g.t_s)
    else:
        freq = p["target_pos_frequency"]
        patch = p["target_pos_patch"].repeat(g.f_s, g.t_s, 1)
        grid = torch.cat([freq[:, None, :].expand(-1, g.t_t, -1), patch],
                         dim=-1)
        order = target_order(g)
    return to_sequence(grid[None], order)[0]


def embed(p, g, kind, tokens, labels, prec):
    """[B, L] tokens -> [B, n_start + L, d]."""
    batch = tokens.shape[0]
    table = p[f"{kind}_embed.weight"]
    emb = prec.linear(table[tokens], p, f"{kind}_embeddings_linear")
    pos = positional_rows(p, g, kind)
    seq = torch.cat([emb, pos[None].expand(batch, -1, -1)], dim=-1)
    return torch.cat([start_block(p, g, kind, labels, batch), seq], dim=1)


def encoder(p, g, x, prec, gens):
    length = x.shape[1]
    mask = None
    if g.self_conditional:  # position i sees j >= i
        i = torch.arange(length, device=x.device)
        mask = torch.where(i[:, None] <= i[None, :], 0.0, NEG_INF)
    for l in range(g.n_enc):
        pre = f"encoder_layers.{l}"
        gen = gens[l] if gens else None
        bias = relative_bias(p[f"{pre}.self_bias.rel_bias"], length, length,
                             1, 1, g.l_s + 1)
        h = layer_norm(x, p, f"{pre}.ln1")
        x = x + dropout(attention(p, f"{pre}.self_attn", h, h, g.heads, bias,
                                  mask, prec), g.dropout, gen)
        x = x + feed_forward(p, f"{pre}.mlp", layer_norm(x, p, f"{pre}.ln2"),
                             g.dropout, gen, prec)
    return layer_norm(x, p, "encoder_norm")


def feed_forward(p, name, x, rate, gen, prec):
    h = dropout(torch.relu(prec.linear(x, p, f"{name}.fc1")), rate, gen)
    return prec.linear(h, p, f"{name}.fc2")


def decoder(p, g, x, memory, prec, gens):
    len_q, len_k = x.shape[1], memory.shape[1]
    i = torch.arange(len_q, device=x.device)
    causal = torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)
    cross_mask = None
    if g.aligned:  # event e sees source position e alone
        j = torch.arange(len_k, device=x.device)
        cross_mask = torch.where((i // g.channels)[:, None] == j[None, :],
                                 0.0, NEG_INF)
    for l in range(g.n_dec):
        pre = f"decoder_layers.{l}"
        gen = gens[l] if gens else None
        self_bias = relative_bias(p[f"{pre}.self_bias.rel_bias"], len_q,
                                  len_q, g.channels, g.channels,
                                  g.events_t + 1)
        h = layer_norm(x, p, f"{pre}.ln1")
        x = x + dropout(attention(p, f"{pre}.self_attn", h, h, g.heads,
                                  self_bias, causal, prec), g.dropout, gen)
        cross_bias = relative_bias(p[f"{pre}.cross_bias.rel_bias"], len_q,
                                   len_k, g.channels, 1, g.l_s + 1)
        x = x + dropout(attention(p, f"{pre}.cross_attn",
                                  layer_norm(x, p, f"{pre}.ln2"), memory,
                                  g.heads, cross_bias, cross_mask, prec),
                        g.dropout, gen)
        x = x + feed_forward(p, f"{pre}.mlp", layer_norm(x, p, f"{pre}.ln3"),
                             g.dropout, gen, prec)
    return layer_norm(x, p, "decoder_norm")


def forward(p, g: Geometry, condition: torch.Tensor, target: torch.Tensor,
            labels: Dict[str, torch.Tensor],
            source_mask: Optional[torch.Tensor] = None,
            prec: Precision = EXACT,
            gens: Optional[Tuple[Sequence, Sequence]] = None
            ) -> torch.Tensor:
    """Teacher-forced logits [B, L_t, n_class] (float32) of the target
    codemap [B, F_t, T_t] given the condition codemap [B, F_s, T_s] (the
    top prior: its own codemap, with ``source_mask`` [B, F, T] True where a
    cell is hidden behind the mask token), class ``labels`` {name: [B]}
    and, in training, the dropout generators."""
    src = to_sequence(condition.long(), frequency_first(g.f_s, g.t_s))
    if g.self_conditional and source_mask is not None:
        hidden = to_sequence(source_mask, frequency_first(g.f_s, g.t_s))
        src = torch.where(hidden, g.n_class, src)
    tgt = to_sequence(target.long(), target_order(g))
    memory = encoder(p, g, embed(p, g, "source", src, labels, prec), prec,
                     gens[0] if gens else None)
    h = decoder(p, g, embed(p, g, "target", tgt, labels, prec), memory, prec,
                gens[1] if gens else None)
    c = g.channels
    return prec.linear(h[:, c - 1: c - 1 + g.l_t], p, "project_logits")
