"""Plain reference of CoViAR's I-frame scoring (Wu et al., CVPR 2018, arXiv
1712.00636; github.com/chaoyuaw/pytorch-coviar, `test.py --representation
iframe --arch resnet152 --test_segments 25 --test-crops 10`): one video's
score from its I-frames.

  1. GroupOverSample (the reference's transforms.py): every frame scaled to
     `scale_size` x `scale_size` (256²; bilinear, half-pixel centres, the
     edge pixels repeated, as `cv2.resize`'s INTER_LINEAR), then 5 crops of
     `input_size` (224²) at the corners and the centre (offsets 0 and 4 x
     and 2 x (scale_size - input_size) // 4), each as is and mirrored:
     crop-major clips, (offset 0, mirrored offset 0, offset 1, ...) x the
     segments;
  2. the iframe normalize: / 255, minus ImageNet's mean, over its std, per
     RGB channel;
  3. the bottleneck ResNet (He et al., arXiv 1512.03385; torchvision's
     graph, "v1.5": the stride on the 3x3 conv, a 1x1/BN projection on
     each stage's first block), inference BatchNorm, a linear layer from
     the pooled 2048 features to the classes (the TSN head);
  4. the video's score: the mean of its clips' logits.

Departures from the published description:

  * the input is the u8 canvas as the port's `BatchAssembler` lays out an
    iframe group, (S, H, W, 8): RGB at channels 2:5 beside the flow and
    residual slots (the reference decodes BGR with its own loader and flips
    it to RGB; decoding is not this file's business);
  * the scaled frame is kept in float, where `cv2.resize` rounds it to u8
    (the port's one-pass resampler never rounds);
  * `calibrate` gives seeded weights the shape of a trained network's:
    each block's last BatchNorm scaled by `residual_gain`, then every
    BatchNorm's statistics set from the configuration's own input.

Parameters are read by the port's `PlainTSN` key names (`base_model.` +
torchvision's).  Nothing here is folded or fused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.dmcnet import BN_EPS, _bn_shapes
from benchmark.reference.precision import conv, linear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RGB = slice(2, 5)
PREFIX = "base_model."


def _block_plan(cfg):
    """[(prefix, c_in, width, stride)] of every bottleneck block."""
    plan, c = [], cfg["stem_width"]
    for s, (n, w) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
        for b in range(n):
            plan.append((f"{PREFIX}layer{s + 1}.{b}.", c, w,
                         2 if s and not b else 1))
            c = w * cfg["expansion"]
    return plan, c


def shapes(cfg):
    """[(key, shape, kind)] of the plain TSN's state dict."""
    e, c0 = cfg["expansion"], cfg["stem_width"]
    out = [(PREFIX + "conv1.weight", (c0, cfg["in_channels"], 7, 7), "conv")]
    out += _bn_shapes(PREFIX + "bn1.", c0)
    plan, c_last = _block_plan(cfg)
    for p, c, w, stride in plan:
        out += [(p + "conv1.weight", (w, c, 1, 1), "conv")]
        out += _bn_shapes(p + "bn1.", w)
        out += [(p + "conv2.weight", (w, w, 3, 3), "conv")]
        out += _bn_shapes(p + "bn2.", w)
        out += [(p + "conv3.weight", (w * e, w, 1, 1), "conv")]
        out += _bn_shapes(p + "bn3.", w * e)
        if stride != 1 or c != w * e:
            out += [(p + "downsample.0.weight", (w * e, c, 1, 1), "conv")]
            out += _bn_shapes(p + "downsample.1.", w * e)
    return out + [(PREFIX + "fc.weight", (cfg["num_class"], c_last),
                   "linear"),
                  (PREFIX + "fc.bias", (cfg["num_class"],), "bias")]


def bn(x, sd, p, calibrate=False):
    """Inference BatchNorm; with `calibrate`, its running mean and variance
    in `sd` are first set to x's per-channel mean and (biased) variance."""
    if calibrate:
        sd[p + "running_mean"].copy_(x.mean((0, 2, 3)))
        sd[p + "running_var"].copy_(x.var((0, 2, 3), unbiased=False))
    return F.batch_norm(x, sd[p + "running_mean"], sd[p + "running_var"],
                        sd[p + "weight"], sd[p + "bias"], False, 0.0, BN_EPS)


def resnet(sd, cfg, x, q=None, calibrate=False):
    """(N, 3, S, S) normalized clips -> (N, C) logits."""
    x = F.relu(bn(conv(x, sd[PREFIX + "conv1.weight"], None, q, stride=2,
                       padding=3), sd, PREFIX + "bn1.", calibrate))
    x = F.max_pool2d(x, 3, 2, 1)
    for p, _, _, stride in _block_plan(cfg)[0]:
        idt = x
        if p + "downsample.0.weight" in sd:
            idt = bn(conv(x, sd[p + "downsample.0.weight"], None, q,
                          stride=stride), sd, p + "downsample.1.", calibrate)
        y = F.relu(bn(conv(x, sd[p + "conv1.weight"], None, q), sd,
                      p + "bn1.", calibrate))
        y = F.relu(bn(conv(y, sd[p + "conv2.weight"], None, q, stride=stride,
                           padding=1), sd, p + "bn2.", calibrate))
        y = bn(conv(y, sd[p + "conv3.weight"], None, q), sd, p + "bn3.",
               calibrate)
        x = F.relu(y + idt)
    return linear(x.mean((2, 3)), sd[PREFIX + "fc.weight"],
                  sd[PREFIX + "fc.bias"], q)


def oversample(canvas, cfg):
    """u8 canvas (S, H, W, 8) -> the normalized clips (10 x S, 3, size,
    size), crop-major."""
    scale, size = cfg["scale_size"], cfg["input_size"]
    rgb = canvas[..., RGB].permute(0, 3, 1, 2).float()
    scaled = F.interpolate(rgb, size=(scale, scale), mode="bilinear",
                           align_corners=False)
    step = (scale - size) // 4
    clips = []
    for row, col in ((0, 0), (4 * step, 0), (0, 4 * step),
                     (4 * step, 4 * step), (2 * step, 2 * step)):
        crop = scaled[:, :, row:row + size, col:col + size]
        clips += [crop, crop.flip(-1)]
    x = torch.cat(clips) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def clip_logits(sd, cfg, canvas, q=None, chunk=50):
    """u8 canvas (S, H, W, 8) -> every clip's logits (10 x S, C), the
    network run on `chunk` clips at a time."""
    x = oversample(canvas, cfg)
    return torch.cat([resnet(sd, cfg, x[i:i + chunk], q)
                      for i in range(0, x.shape[0], chunk)])


def video_score(sd, cfg, canvas, q=None):
    """The video's score (C,): the mean of its clips' logits."""
    return clip_logits(sd, cfg, canvas, q).mean(0)


def calibrate(sd, cfg, canvas):
    """Gives seeded weights `sd` (in place) the shape of a trained
    network's.  Each block's last BatchNorm (`bn3`) weight and bias are
    scaled by `cfg["residual_gain"]`: trained ResNets keep that scale
    small (torchvision's `zero_init_residual` starts it at 0), while at 1
    a stack of 50 unit-gain branches is chaotic, float32 rounding growing
    some thousandfold through it.  Then every BatchNorm's running
    statistics are set to those of its input on the clips of `canvas`,
    layer by layer, each normalized by the statistics set before it, as a
    trained model's statistics normalize its own input."""
    for p, _, _, _ in _block_plan(cfg)[0]:
        for k in ("weight", "bias"):
            sd[p + "bn3." + k].mul_(cfg["residual_gain"])
    with torch.no_grad():
        resnet(sd, cfg, oversample(canvas, cfg), calibrate=True)
