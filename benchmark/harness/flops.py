"""Model operations of a request and of a training step, from shapes.

Two multiply-adds count as two operations. Attention counts the (query,
key) pairs its mask keeps. The decode arithmetic follows
``frozen.prime_bound`` / ``frozen.scan_bound`` term by term, written from
the configuration instead of a kernel's arguments, so a share of the peak
can be taken whichever kernels serve the request.
"""

from __future__ import annotations

from reference.prior import Geometry


def attention_pairs(length_q: int, length_k: int, mask: str) -> int:
    if mask == "causal" or mask == "anti_causal":
        return length_q * (length_q + 1) // 2
    if mask == "aligned":
        return length_q
    return length_q * length_k


def encoder_ops(g: Geometry, batch: int = 1) -> int:
    """The source embedding and the encoder stack, forward."""
    n = g.l_s + 1
    pairs = attention_pairs(n, n, "anti_causal" if g.self_conditional
                            else "full")
    per_layer = 2 * n * g.d * (4 * g.d + 2 * g.d_ff) + 4 * g.d * pairs
    return batch * (g.n_enc * per_layer + 2 * g.l_s * g.emb * g.eff)


def memory_ops(g: Geometry) -> int:
    """The decoder layers' projections of the encoder memory (values only
    for an aligned decoder, whose cross attention sees one key)."""
    n = g.l_s + 1
    return g.n_dec * (1 if g.aligned else 2) * 2 * n * g.d * g.d


def decoder_ops(g: Geometry, batch: int = 1) -> int:
    """The target embedding, decoder stack and logits of a teacher-forced
    forward over the whole target, forward."""
    n = g.l_t + g.channels
    e_src = g.l_s + 1
    per_layer = (2 * n * g.d * (5 * g.d + 2 * g.d_ff)
                 + 4 * g.d * attention_pairs(n, n, "causal"))
    if g.aligned:
        per_layer += 2 * e_src * g.d * g.d  # memory values
    else:
        per_layer += (2 * n * g.d * g.d + 4 * e_src * g.d * g.d
                      + 4 * g.d * n * e_src)
    return batch * (g.n_dec * per_layer + 2 * g.l_t * g.emb * g.eff
                    + 2 * g.l_t * g.d * g.n_class)


def scan_window(g: Geometry, first: int, last: int):
    """(p0, steps): the with-start positions a request samples over, for
    masked tokens ``first`` .. ``last`` (reading order): the known prefix is
    primed, the scan runs through the last masked token."""
    c = g.channels
    p0 = c - 1 + first if first else 0
    return p0, last + c


def prime_ops(g: Geometry, p0: int) -> int:
    if p0 <= 0:
        return 0
    pairs = p0 * (p0 + 1) // 2
    ops = g.n_dec * (2 * p0 * g.d * (5 * g.d + 2 * g.d_ff) + 4 * g.d * pairs)
    if not g.aligned:
        e_src = g.l_s + 1
        ops += g.n_dec * (2 * p0 * g.d * g.d + 4 * p0 * e_src * g.d)
    return ops


def scan_ops(g: Geometry, p0: int, steps: int) -> int:
    s = steps - p0
    keys_seen = sum(p + 1 for p in range(p0, steps))
    per_step = 2 * (g.n_dec * g.d * (5 * g.d + 2 * g.d_ff)
                    + g.d * g.n_class)
    ops = s * per_step + g.n_dec * 4 * g.d * keys_seen
    if not g.aligned:
        e_src = g.l_s + 1
        ops += s * g.n_dec * (2 * g.d * g.d + 4 * e_src * g.d)
    return ops


def vqvae_decode_ops(cfg: dict, top_shape, spec: dict) -> int:
    """The decode's convolutions and the mel inverse's two products, for a
    top codemap of ``top_shape``."""
    vq = cfg
    ch = vq["num_hidden_channels"]
    res = vq["num_residual_channels"]
    dim = vq["embed_dim"]
    f_t = vq["resolution_factors"]["top"]
    f_b = vq["resolution_factors"]["bottom"]
    h, w = top_shape
    ops = 0
    for _ in range(f_t.bit_length() - 1):       # top lifted to the bottom
        ops += 2 * dim * dim * 16 * h * w
        h, w = 2 * h, 2 * w
    ops += 2 * (2 * dim) * ch * 9 * h * w        # conv_in
    ops += vq["n_res_block"] * (2 * ch * res * 9 * h * w
                                + 2 * res * ch * h * w)
    sched = {16: (ch // 4, ch // 2, 3 * ch // 4), 8: (ch // 2, ch // 2),
             4: (ch // 2,), 2: ()}[f_b]
    chans = (ch,) + tuple(reversed(sched)) + (vq["in_channel"],)
    for a, b in zip(chans[:-1], chans[1:]):
        ops += 2 * a * b * 16 * h * w
        h, w = 2 * h, 2 * w
    bins = spec["n_fft"] // 2
    return ops + 2 * (2 * w * bins * bins)


def training_step_ops(g: Geometry, batch: int) -> int:
    """Forward and backward (twice the forward's products) of one step."""
    forward = encoder_ops(g, batch) + decoder_ops(g, batch)
    return 3 * forward
