"""The yardstick's arithmetic for XMem: the FLOPs of one video frame.

Frozen here, beside the benchmark, so that a change to the program cannot
move it. Every count is worked out from shapes (a multiply-add is 2 FLOPs),
never read from the program. Only convolutions, linear layers and the
memory's two products are counted; batch norms, activations, pooling,
resizes, soft-maxes, top-k, the soft aggregation, consolidation and the
host's work are not. The published network's work is counted, not the
program's: the decoder's skip convolutions once per image (the program
runs them once per object), and the memory readout at its top-k work, so
that a sparse readout cannot push a share past 100%.
"""

from __future__ import annotations


def conv(cin: int, cout: int, k: int, hw: int) -> float:
    """A k x k convolution from ``cin`` to ``cout`` channels with ``hw``
    output positions."""
    return 2.0 * cin * cout * k * k * hw


def _bottleneck(cin: int, mid: int, hw_in: int, stride: int) -> float:
    hw = hw_in // (stride * stride)
    out = conv(cin, mid, 1, hw_in) + conv(mid, mid, 3, hw) + conv(mid, 4 * mid, 1, hw)
    return out + (conv(cin, 4 * mid, 1, hw) if stride != 1 or cin != 4 * mid else 0.0)


def _basic(cin: int, cout: int, hw_in: int, stride: int) -> float:
    hw = hw_in // (stride * stride)
    out = conv(cin, cout, 3, hw) + conv(cout, cout, 3, hw)
    return out + (conv(cin, cout, 1, hw) if stride != 1 or cin != cout else 0.0)


def _layer(block, cin: int, width: int, blocks: int, hw_in: int, stride: int) -> float:
    grow = 4 if block is _bottleneck else 1
    total = block(cin, width, hw_in, stride)
    hw = hw_in // (stride * stride)
    return total + (blocks - 1) * block(width * grow, width, hw, 1)


def _group_res(cin: int, cout: int, hw: int) -> float:
    return conv(cin, cout, 3, hw) + conv(cout, cout, 3, hw) + (
        conv(cin, cout, 3, hw) if cin != cout else 0.0)


def _fusion(x_dim: int, g_dim: int, mid: int, out: int, hw: int) -> float:
    """The feature fusion block of one object: two res blocks and CBAM
    (its MLP over two pooled vectors, its 7x7 spatial convolution)."""
    cbam = 2 * (2.0 * mid * (mid // 16) * 2) + conv(2, 1, 7, hw)
    return _group_res(x_dim + g_dim, mid, hw) + cbam + _group_res(mid, out, hw)


def key_encoder_flops(H: int, W: int, key_dim: int) -> float:
    """ResNet-50 to stride 16 on one (H, W) image (H, W multiples of 16),
    and the key, shrinkage and selection projections."""
    hw2, hw4 = (H // 2) * (W // 2), (H // 4) * (W // 4)
    hw16 = (H // 16) * (W // 16)
    return (conv(3, 64, 7, hw2) + _layer(_bottleneck, 64, 64, 3, hw4, 1)
            + _layer(_bottleneck, 256, 128, 4, hw4, 2)
            + _layer(_bottleneck, 512, 256, 6, hw4 // 4, 2)
            + conv(1024, 2 * key_dim + 1, 3, hw16))


def value_encoder_flops(H: int, W: int, value_dim: int, hidden_dim: int) -> float:
    """One object's value: ResNet-18 to stride 16 over 5 channels, the
    fusion with the image's stride-16 features, the hidden reinforcer."""
    hw2, hw4 = (H // 2) * (W // 2), (H // 4) * (W // 4)
    hw16 = (H // 16) * (W // 16)
    return (conv(5, 64, 7, hw2) + _layer(_basic, 64, 64, 2, hw4, 1)
            + _layer(_basic, 64, 128, 2, hw4, 2) + _layer(_basic, 128, 256, 2, hw4 // 4, 2)
            + _fusion(1024, 256, value_dim, value_dim, hw16)
            + conv(value_dim + hidden_dim, 3 * hidden_dim, 3, hw16))


def decoder_object_flops(H: int, W: int, value_dim: int, hidden_dim: int,
                         h_out: bool) -> float:
    """One object's decoding: the fusion of its readout and hidden state,
    the two upsampling blocks' res blocks, the logit head, and with
    ``h_out`` the hidden updater."""
    hw16, hw8, hw4 = (H // 16) * (W // 16), (H // 8) * (W // 8), (H // 4) * (W // 4)
    total = (_fusion(1024, value_dim + hidden_dim, 512, 512, hw16) + _group_res(512, 256, hw8)
             + _group_res(256, 256, hw4) + conv(256, 1, 3, hw4))
    if h_out:
        total += (conv(512, 256, 1, hw16) + conv(256, 256, 1, hw16) + conv(257, 256, 1, hw16)
                  + conv(256 + hidden_dim, 3 * hidden_dim, 3, hw16))
    return total


def decoder_image_flops(H: int, W: int) -> float:
    """The decoder's skip convolutions, once per image."""
    return conv(512, 512, 3, (H // 8) * (W // 8)) + conv(256, 256, 3, (H // 4) * (W // 4))


def read_flops(key_dim: int, value_dim: int, objects: int, top_k: int, elements: int,
               queries: int) -> float:
    """The memory read over ``elements`` memory elements for ``queries``
    query positions: the similarity, one product of depth 2 * key_dim over
    elements x queries, and the readout at its top-k work."""
    k = min(top_k, elements)
    return 2.0 * 2 * key_dim * elements * queries + 2.0 * objects * value_dim * k * queries


def frame_flops(xmem: dict, H: int, W: int, objects: int, seed: bool, memory: bool,
                elements: int) -> float:
    """One frame on the padded (H, W) grid: the key encoder; unless it is
    the ``seed`` frame, the read over ``elements`` and the decoder (its
    hidden update on frames that are not ``memory`` frames); on a memory
    frame the value encoder, each per object."""
    total = key_encoder_flops(H, W, xmem["key_dim"])
    cv, ch = xmem["value_dim"], xmem["hidden_dim"]
    if not seed:
        total += read_flops(xmem["key_dim"], cv, objects, xmem["top_k"], elements,
                            (H // 16) * (W // 16))
        total += decoder_image_flops(H, W) + objects * decoder_object_flops(
            H, W, cv, ch, h_out=not memory)
    if memory:
        total += objects * value_encoder_flops(H, W, cv, ch)
    return total
