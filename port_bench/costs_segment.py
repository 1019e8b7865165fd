"""The yardstick's arithmetic for open-text segmentation: the FLOPs of a
request and the bytes of a ``deform_gather`` launch.

Frozen here, beside the benchmark, so that a change to the program cannot
move it. Every count is worked out from shapes (a multiply-add is 2 FLOPs),
never read from the program. Only matrix products and convolutions are
counted (attention's two products included); norms, soft-maxes,
activations, the deformable sampling and the host's work are not.
"""

from __future__ import annotations

from port_bench.costs import PEAK_BYTES_PER_S  # noqa: F401  (the rate the bound uses)


def deform_gather_bytes(B: int, S: int, Q: int, nh: int, hd: int, L: int, P: int,
                        itemsize: int) -> float:
    """The least traffic of one launch, each array moved once: the (B, S,
    nh, hd) ``value`` table at ``itemsize`` bytes, the (B, Q, nh, L, P, 2)
    f32 sampling locations and (B, Q, nh, L, P) f32 weights read, the (B,
    Q, nh*hd) f32 output written. At the encoder's bf16 launch (B=4,
    S=Q=17,821, nh=8, hd=32, L=P=4): 219.0 MB (PERF.md's kernel table)."""
    return float(B * S * nh * hd * itemsize + B * Q * nh * L * P * 3 * 4 + B * Q * nh * hd * 4)


def deform_gather_bound_s(launch: dict) -> float:
    """The least time of one launch on the card: its bytes at the HBM rate."""
    return deform_gather_bytes(**launch) / PEAK_BYTES_PER_S


def _linear(tokens: int, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def _attention(queries: int, keys: int, width: int) -> float:
    """q k^T and p v over all heads together."""
    return 4.0 * queries * keys * width


def sam_encoder_flops(s: dict, views: int) -> float:
    """SAM's image encoder on ``views`` 1024x1024 inputs: the patch
    embedding; per layer qkv and the output projection on the tokens the
    attention sees (a windowed layer's grid padded to a multiple of the
    window: 70x70 at 64 and 14), the two products of each window or of the
    whole grid, the decomposed relative positions (each query against its
    row's and column's tables), the MLP on the grid's tokens; the neck."""
    D, G, w = s["hidden_size"], s["image_size"] // s["patch_size"], s["window_size"]
    hd = D // s["num_heads"]
    grid = G * G
    total = _linear(grid, 3 * s["patch_size"] ** 2, D)
    for i in range(s["num_layers"]):
        if i in s["global_attn_indexes"]:
            side, seen, attn = G, grid, _attention(grid, grid, D)
        else:
            side = w
            Gp = G + (-G) % w
            seen = Gp * Gp
            attn = (Gp // w) ** 2 * _attention(w * w, w * w, D)
        rel = 2.0 * seen * s["num_heads"] * hd * 2 * side
        total += (_linear(seen, D, 3 * D) + _linear(seen, D, D) + attn + rel
                  + _linear(grid, D, s["mlp_dim"]) + _linear(grid, s["mlp_dim"], D))
    C = s["output_channels"]
    total += _linear(grid, D, C) + _linear(grid, 9 * C, C)
    return views * total


def sam_decoder_flops(s: dict, boxes: int) -> float:
    """SAM's mask decoder for ``boxes`` box prompts (7 tokens each against
    the 64x64 grid): the two-way layers, the final attention, the
    upscaling, the hypernetworks' masks and the IoU head."""
    C, G = s["prompt_hidden"], s["image_size"] // s["patch_size"]
    T, N, h = s["num_multimask_outputs"] + 1 + 1 + 2, G * G, C // 2

    def cross(q, k, internal):
        return (_linear(q, C, internal) + 2 * _linear(k, C, internal) + _attention(q, k, internal)
                + _linear(q, internal, C))

    per = 0.0
    for _ in range(s["decoder_layers"]):
        per += cross(T, T, C) + cross(T, N, h) + cross(N, T, h)
        per += _linear(T, C, s["decoder_mlp_dim"]) + _linear(T, s["decoder_mlp_dim"], C)
    per += cross(T, N, h)
    per += _linear(N, C, C // 4 * 4) + _linear(4 * N, C // 4, C // 8 * 4)
    nm = s["num_multimask_outputs"] + 1
    per += nm * (2 * _linear(1, C, C) + _linear(1, C, C // 8)) + _linear(16 * N, C // 8, nm)
    per += 2 * _linear(1, C, s["iou_head_hidden"]) + _linear(1, s["iou_head_hidden"], nm)
    return boxes * per


def swin_flops(sw: dict, H: int, W: int) -> float:
    """Swin on one H x W image: patch embedding; per block qkv, output and
    MLP on the tokens (the window attention on the grid padded to its
    window), the window products; patch merging."""
    p, w, r = sw["patch_size"], sw["window_size"], sw["mlp_ratio"]
    gh, gw = -(-H // p), -(-W // p)
    total = _linear(gh * gw, 3 * p * p, sw["embed_dim"])
    for si, depth in enumerate(sw["depths"]):
        C = sw["embed_dim"] * 2 ** si
        Hp, Wp = gh + (-gh) % w, gw + (-gw) % w
        per_block = (_linear(Hp * Wp, C, 3 * C) + _linear(Hp * Wp, C, C)
                     + (Hp // w) * (Wp // w) * _attention(w * w, w * w, C)
                     + 2 * _linear(gh * gw, C, int(C * r)))
        total += depth * per_block
        if si < len(sw["depths"]) - 1:
            gh, gw = (gh + 1) // 2, (gw + 1) // 2
            total += _linear(gh * gw, 4 * C, 2 * C)
    return total


def gdino_levels(g: dict, H: int, W: int):
    """The (h, w) of the detector's levels for an H x W input."""
    sw = g["swin"]
    h, w = -(-H // sw["patch_size"]), -(-W // sw["patch_size"])
    sizes = [(h, w)]
    for _ in range(len(sw["depths"]) - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        sizes.append((h, w))
    levels = [sizes[i] for i in sw["out_stages"]]
    while len(levels) < g["num_feature_levels"]:
        h, w = levels[-1]
        levels.append(((h + 1) // 2, (w + 1) // 2))
    return levels


def gdino_flops(g: dict, views: int, H: int, W: int, text_len: int) -> float:
    """GroundingDINO on ``views`` H x W inputs (at the detector's size) and a
    caption of ``text_len`` tokens: Swin, the input projections, BERT, the 6
    encoder layers (fusion, text enhancer, deformable attention's
    projections, FFN), query selection and the 6 decoder layers."""
    sw, tx, d = g["swin"], g["text"], g["d_model"]
    levels = gdino_levels(g, H, W)
    S = sum(h * w for h, w in levels)
    total = views * swin_flops(sw, H, W)
    for li, (h, w) in enumerate(levels):
        if li < len(sw["out_stages"]):
            c_in, k = sw["embed_dim"] * 2 ** sw["out_stages"][li], 1
        else:
            c_in, k = (sw["embed_dim"] * 2 ** sw["out_stages"][-1]
                       if li == len(sw["out_stages"]) else d), 3
        total += views * _linear(h * w, c_in * k * k, d)
    D, Lt = tx["hidden_size"], text_len
    bert = tx["num_layers"] * (4 * _linear(Lt, D, D) + _attention(Lt, Lt, D)
                               + 2 * _linear(Lt, D, tx["intermediate_size"]))
    total += views * (bert + _linear(Lt, D, d))
    E, ffn, nh = g["encoder_ffn_dim"] // 2, g["encoder_ffn_dim"], g["encoder_heads"]
    L, Pe, Pd = g["num_feature_levels"], g["encoder_points"], g["decoder_points"]

    def deform(q, s, heads, points):
        return (_linear(s, d, d) + _linear(q, d, heads * L * points * 3)
                + _linear(q, d, d))

    enc = (2 * _linear(S, d, E) + 2 * _linear(Lt, d, E) + _attention(S, Lt, E)
           + _linear(S, E, d) + _linear(Lt, E, d)
           + 4 * _linear(Lt, d, d) + _attention(Lt, Lt, d) + 2 * _linear(Lt, d, E)
           + deform(S, S, nh, Pe) + 2 * _linear(S, d, ffn))
    total += views * g["encoder_layers"] * enc
    Q = g["num_queries"]
    sel = _linear(S, d, d) + _linear(S, d, Lt) + 2 * _linear(S, d, d) + _linear(S, d, 4)
    dec = (4 * _linear(Q, d, d) + _attention(Q, Q, d) + 4 * _linear(Q, d, d)
           + 2 * _linear(Lt, d, d) + _attention(Q, Lt, d)
           + deform(Q, S, g["decoder_heads"], Pd) + 2 * _linear(Q, d, g["decoder_ffn_dim"])
           + _linear(Q, 2 * d, d) + _linear(Q, d, d) + 2 * _linear(Q, d, d) + _linear(Q, d, 4))
    head = _linear(Q, d, Lt) + 2 * _linear(Q, d, d) + _linear(Q, d, 4)
    total += views * (sel + g["decoder_layers"] * dec + head)
    return total


def segment_flops(config: dict, views: int, boxes: int = 0, text_len: int = 0) -> float:
    """One request: GroundingDINO over the views at the detector's size,
    SAM's encoder over the views and its decoder over ``boxes`` prompts.
    ``text_len`` defaults to the caption of the configuration's queries
    (one token a word, a separator a query, [CLS] and [SEP])."""
    g, s, rig = config["gdino"], config["sam"], config["rig"]
    H, W = rig["height"], rig["width"]
    sc = g["short_side"] / min(H, W)
    if max(H, W) * sc > g["max_side"]:
        sc = g["max_side"] / max(H, W)
    text_len = text_len or 2 + sum(len(q.split()) + 1 for q in config["queries"])
    return (gdino_flops(g, views, round(H * sc), round(W * sc), text_len)
            + sam_encoder_flops(s, views) + sam_decoder_flops(s, boxes))
