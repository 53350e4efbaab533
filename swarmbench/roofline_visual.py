"""Operations and bytes of the learned visual front end's three networks,
for the shares of peak of the stereo cells. Peaks are `roofline.py`'s.

Operations count 2 per multiply-add of the convolutions, the linear
layers and the attention products, at the shapes the networks compute:
SuperPoint on the whole frame (widths 64-64-128-128, the 65-way detector
head and the 256-d descriptor head), CosPlace's ResNet-18 on the square
crop and its linear head, LightGlue at the VALID keypoint counts of a
pair (padded slots are not work). Softmaxes, norms and activations are
left out. Bytes count each convolution's or linear layer's input,
weights and output once, in its precision: the least traffic the layer
needs.
"""

from swarmbench.roofline import ELEMENT_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS

SP_ENCODER = ((1, 64), (64, 64), (64, 64), (64, 64), (64, 128),
              (128, 128), (128, 128), (128, 128))


def _conv(h, w, c_in, c_out, k, stride=1, pad=None):
    """(multiply-adds, input, weight and output elements, out h, out w)."""
    pad = k // 2 if pad is None else pad
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    macs = ho * wo * k * k * c_in * c_out
    return macs, h * w * c_in + k * k * c_in * c_out + ho * wo * c_out, ho, wo


def superpoint_layers(height, width, descriptor_dim=256):
    """[(precision, multiply-adds, elements)] of one frame's forward: the
    3x3 convolutions in bfloat16, the 1x1 heads in float32."""
    out = []
    h, w = height, width
    for i, (c_in, c_out) in enumerate(SP_ENCODER):
        macs, el, h, w = _conv(h, w, c_in, c_out, 3)
        out.append(("bfloat16", macs, el))
        if i in (1, 3, 5):
            h, w = h // 2, w // 2
    for mid, last in ((256, 65), (256, descriptor_dim)):
        macs, el, _, _ = _conv(h, w, 128, mid, 3)
        out.append(("bfloat16", macs, el))
        macs, el, _, _ = _conv(h, w, mid, last, 1)
        out.append(("float32", macs, el))
    return out


def cosplace_layers(crop, dim=64):
    """[(precision, multiply-adds, elements)] of one image's forward:
    ResNet-18's convolutions in bfloat16, the head in float32."""
    out = []
    macs, el, h, w = _conv(crop, crop, 3, 64, 7, 2, 3)
    out.append(("bfloat16", macs, el))
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1       # max pool
    c = 64
    for stage, width in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if (stage and not block) else 1
            m1, e1, ho, wo = _conv(h, w, c, width, 3, stride)
            m2, e2, _, _ = _conv(ho, wo, width, width, 3)
            out += [("bfloat16", m1, e1), ("bfloat16", m2, e2)]
            if stride != 1 or c != width:
                m3, e3, _, _ = _conv(h, w, c, width, 1, stride, 0)
                out.append(("bfloat16", m3, e3))
            h, w, c = ho, wo, width
    out.append(("float32", 512 * dim, 512 + 512 * dim + dim))
    return out


def lightglue_macs(n0, n1, layers, dim=256):
    """Multiply-adds of one pair at n0 and n1 valid keypoints: per layer
    self-attention on each side (projections 4 d^2 and the feed-forward
    6 d^2 a keypoint, the two n x n products), cross-attention (shared
    to_qk, to_v, to_out and the feed-forward, 9 d^2 a keypoint, the n0 x
    n1 similarity and both message products), then the assignment."""
    per_layer = (19 * (n0 + n1) * dim * dim + 2 * (n0 * n0 + n1 * n1) * dim
                 + 3 * n0 * n1 * dim)
    head = (n0 + n1) * (dim * dim + dim) + n0 * n1 * dim
    return layers * per_layer + head


def lightglue_elements(n0, n1, layers, dim=256):
    """Elements each layer must read or write at least once: the weights
    (~24 d^2), both sides' activations, the attention logits."""
    weights = layers * 24 * dim * dim + 2 * dim * dim
    act = layers * 12 * (n0 + n1) * dim
    logits = layers * 4 * (n0 * n0 + n1 * n1 + 2 * n0 * n1)
    return weights + act + logits


def peak_seconds(layers):
    """Least seconds of [(precision, multiply-adds, elements)] at the
    peaks: the operations over each precision's peak, summed."""
    return sum(2.0 * macs / PEAK_FLOPS[p] for p, macs, _ in layers)


def bound_seconds(layers):
    """Least seconds of the layers one after another, each the larger of
    its operations over its peak and its bytes over HBM bandwidth."""
    return sum(max(2.0 * macs / PEAK_FLOPS[p],
                   el * ELEMENT_BYTES[p] / HBM_BYTES_PER_S)
               for p, macs, el in layers)


def lightglue_layers(n0, n1, layers, dim=256):
    """LightGlue of one pair as one float32 layer list entry."""
    return [("float32", lightglue_macs(n0, n1, layers, dim),
             lightglue_elements(n0, n1, layers, dim))]
