"""The least work of one unit of a configuration, counted from its shapes.

A unit is one two-stream frame of the guided network (``model: guided``)
or one training step of the step-1 densifier (``model: step1``): the
models of the built-in loops (:data:`.cells.LOOPS`), in :data:`WORK`. A
model that comes in with a loop file (``benchmark/loops/<loop>.py``) is
counted there, or in a module of its own that the loop file imports, from
:class:`Work` and :func:`conv_flops` by the same rules; ``WORK`` is not
edited for it. Every
conv, normalized conv and pool of the configuration is listed with its
shapes and its compute dtype, whatever kernel runs it, so a fused or
faster kernel changes the time and never the count.

  * a conv: 2 cout cin k^2 ho wo B operations; a transposed conv the same
    over its input pixels; a normalized conv two convs (numerator and
    denominator); a 2x2 max pool 3 comparisons an output, for the signal
    and the confidence each;
  * training adds, for each normalized conv, the weight cotangent (two
    convs' worth) and, but for the first layer (whose input is data), the
    input cotangent (two convs' worth);
  * least bytes: what any implementation must move once: the wire or the
    batch in, the weights in their stored type, the outputs; a training
    step also reads and writes the parameters and AdamW's two moments.

Peaks are the published dense rates of one NVIDIA H100 SXM at 700 W: 989
TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s.
"""
from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bf16": 2, "f32": 4}


@dataclass
class Work:
    ops: list = field(default_factory=list)  # (name, dtype, flops, params)
    bytes: float = 0.0

    def add(self, name, dtype, flops, params=0):
        self.ops.append((name, dtype, float(flops), int(params)))

    def flops(self, dtype=None) -> float:
        return sum(f for _, d, f, _ in self.ops if dtype in (None, d))

    @property
    def flops_s(self) -> float:
        """Seconds at the peak of each op's dtype."""
        return sum(f / PEAK_FLOPS[d] for _, d, f, _ in self.ops)

    @property
    def bytes_s(self) -> float:
        return self.bytes / PEAK_BYTES

    @property
    def least_s(self) -> float:
        return max(self.flops_s, self.bytes_s)


def conv_flops(cin, cout, k, ho, wo, b):
    return 2 * cout * cin * k * k * ho * wo * b


def _step1(work: Work, c: int, h: int, w: int, b: int, *, train: bool) -> None:
    """The nine normalized convs and three pools of the densifier, f32."""
    layers = [  # name, cin, cout, k, output rows, output columns
        ("nconv1", 1, c, 5, h, w), ("nconv2", c, c, 5, h, w),
        ("nconv_down1", c, c, 5, h // 2, w // 2), ("nconv_down2", c, c, 5, h // 4, w // 4),
        ("nconv_down3", c, c, 5, h // 8, w // 8), ("nconv4", 2 * c, c, 3, h // 4, w // 4),
        ("nconv5", 2 * c, c, 3, h // 2, w // 2), ("nconv6", 2 * c, c, 3, h - 2, w - 2),
        ("nconv7", c, 1, 1, h, w),
    ]
    for name, cin, cout, k, ho, wo in layers:
        f = 2 * conv_flops(cin, cout, k, ho, wo, b)
        work.add(name, "f32", f, cin * cout * k * k + cout)
        if train:
            work.add(f"{name}.weight_grad", "f32", f)
            if name != "nconv1":
                work.add(f"{name}.input_grad", "f32", f)
    for level in (1, 2, 3):
        hp, wp = h >> level, w >> level
        work.add(f"pool{level}", "f32", 2 * 3 * c * hp * wp * b)


def guided_frame(cfg: dict) -> Work:
    """One request: both streams through the guided network."""
    h, w, b = cfg["height"], cfg["width"], cfg["streams"] * cfg["batch"]
    fdt = cfg["feature_dtype"]
    work = Work()
    _step1(work, cfg["step1_channels"], h, w, b, train=False)
    feature_params = 0

    def conv(name, cin, cout, ho, wo, k=3, bias=True):
        nonlocal feature_params
        p = cin * cout * k * k + (cout if bias else 0)
        feature_params += p
        work.add(name, fdt, conv_flops(cin, cout, k, ho, wo, b), p)

    enc, res, cin = cfg["rgb_encoder_channels"], [], 3
    hh, ww = h, w
    for i, (cout, s) in enumerate(zip(enc, cfg["rgb_encoder_strides"])):
        hh, ww = hh // s, ww // s
        conv(f"rgb_encoder{i}", cin, cout, hh, ww)
        conv(f"rgb_encoder{i}.shortcut", cin, cout, hh, ww, k=1, bias=False)
        res.append((cout, hh, ww))
        cin = cout
    feats = cfg["fusion_features"]
    for k, (f, scale) in enumerate(zip(feats, cfg["fusion_scales"])):
        cin, hk, wk = res[len(res) - 1 - k]
        if (hk, wk) != (h // scale, w // scale):
            raise ValueError(f"fusion stage {k} at 1/{scale} does not meet the encoder's {hk}x{wk}")
        if k:
            prev, (hp, wp) = feats[k - 1], (h // cfg["fusion_scales"][k - 1], w // cfg["fusion_scales"][k - 1])
            p = (1 + prev) * cin * 16 + cin
            feature_params += p
            work.add(f"fuse{k}.upf", fdt, conv_flops(1 + prev, cin, 4, hp, wp, b), p)
            conv(f"fuse{k}.upcat", 2 * cin, cin, hk, wk)
        conv(f"fuse{k}.rgb_conv", cin, cin, hk, wk)
        conv(f"fuse{k}.depth_conv", 1, cin, hk, wk)
        conv(f"fuse{k}.fuse_conv1", 2 * cin, cin, hk, wk)
        conv(f"fuse{k}.fuse_conv2", cin, f, hk, wk)
        conv(f"fuse{k}.fuse_conv3", f, f, hk, wk)
        conv(f"fuse{k}.head", f, 1, hk, wk, bias=False)
    step1_params = sum(p for name, _, _, p in work.ops if name.startswith("nconv"))
    wire = b * h * w * (3 * 1 + 2)  # uint8 RGB, uint16 depth
    work.bytes = wire + feature_params * DTYPE_BYTES[fdt] + step1_params * 4 + b * h * w * 4
    return work


def step1_train(cfg: dict) -> Work:
    """One AdamW step of the densifier on a batch."""
    h, w, b = cfg["height"], cfg["width"], cfg["batch"]
    work = Work()
    _step1(work, cfg["channels"], h, w, b, train=True)
    params = sum(p for _, _, _, p in work.ops)
    work.bytes = 2 * b * h * w * 4 + 6 * params * 4 + 4  # depth and gt in; params, m, v read and written
    return work


WORK = {"guided": guided_frame, "step1": step1_train}


def of(cfg: dict) -> Work:
    return WORK[cfg["model"]](cfg)
