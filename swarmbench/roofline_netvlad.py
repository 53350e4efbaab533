"""Operations and bytes of NetVLAD with its projection, for the NetVLAD
cell's shares of peak. Peaks are `roofline.py`'s; the layer lists are
`roofline_visual.py`'s [(precision, multiply-adds, elements)].

Operations count 2 per multiply-add: VGG-16's 13 convolutions through
conv5_3 on the square crop (bfloat16 inputs, as the program runs them),
the NetVLAD layer's 1x1 assignment and its residual sums (the product of
the K x P assignment with the P x C features, and the K x C centroid
term), and the projection's (B x K C) by (K C x D) product (float32).
Pools, softmaxes, norms and activations are left out. Bytes count each
layer's input, weights and output once in its precision; the
projection's K C x D matrix is read once a batch.
"""

from swarmbench.reference_netvlad import VGG16
from swarmbench.roofline import ELEMENT_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS
from swarmbench.roofline_visual import _conv, peak_seconds

# conv5_3's channels: the width of the local descriptors VLAD pools
CHANNELS = 512


def vgg16_layers(crop):
    """[(precision, multiply-adds, elements)] of one image's convolutions
    through conv5_3, and the conv5 map's (h, w)."""
    out = []
    h = w = crop
    c_in = 3
    for c in VGG16:
        if c == "M":
            h, w = h // 2, w // 2
            continue
        macs, el, h, w = _conv(h, w, c_in, c, 3)
        out.append(("bfloat16", macs, el))
        c_in = c
    return out, (h, w)


def vlad_layer(h, w, clusters, channels=CHANNELS):
    """One image's NetVLAD layer: the assignment (K C a position) and the
    residual sums (K C a position, plus K C for the centroid term);
    elements: the map, the assignment kernel and centroids, the vector."""
    p = h * w
    macs = 2 * clusters * channels * p + clusters * channels
    elements = channels * p + 2 * clusters * channels + clusters * channels
    return ("float32", macs, elements)


def projection(batch, in_dim, out_dim):
    """A batch's projection: its (batch, in) by (in, out) product, the
    matrix read once."""
    return ("float32", batch * in_dim * out_dim,
            in_dim * out_dim + batch * in_dim + batch * out_dim + in_dim)


def image_layers(crop, clusters, pca_dim):
    """One image's whole forward, the projection counted for a batch of
    one (the operations; a batch's bytes come from `batch_bound_s`)."""
    convs, (h, w) = vgg16_layers(crop)
    out = convs + [vlad_layer(h, w, clusters)]
    if pca_dim:
        out.append(projection(1, clusters * CHANNELS, pca_dim))
    return out


def _bound(layer):
    p, macs, el = layer
    return max(2.0 * macs / PEAK_FLOPS[p],
               el * ELEMENT_BYTES[p] / HBM_BYTES_PER_S)


def batch_bound_s(images, crop, clusters, pca_dim):
    """Least seconds of one batch's forward: the convolutions' operations
    over the bfloat16 peak, plus the VLAD layer's and the projection's
    larger of operations over the float32 peak and bytes over HBM
    bandwidth."""
    convs, (h, w) = vgg16_layers(crop)
    s = images * peak_seconds(convs)
    p, macs, el = vlad_layer(h, w, clusters)
    s += _bound((p, images * macs, images * el))
    if pca_dim:
        s += _bound(projection(images, clusters * CHANNELS, pca_dim))
    return s
