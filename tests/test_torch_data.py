"""The port's data layer against the JAX package's, on the CPU: its PNG codec
against PIL (every colour type at 8 and 16 bits, all five row filters;
interlaced and other unread files raise), every ``io`` and ``sparsify``
function and every dataset reader bitwise equal to ``nconv_tpu.data``'s on
the same files and the same generator seeds. The dataset fixture trees are
built as tests/test_data.py builds them."""
import io as bytes_io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nconv_tpu import data as jdata
from nconv_tpu.data import io as jio
from nconv_tpu.data import sparsify as jsparsify
from nconv_tpu_torch import data
from nconv_tpu_torch.data import io, png, sparsify

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def write_filtered(a, ctype, depth, palette=None, filters=(0, 1, 2, 3, 4), interlace=0):
    """A PNG whose rows cycle through ``filters``, written from the PNG
    specification's filter definitions (independent of the decoder)."""
    a = np.asarray(a)
    h, w = a.shape[:2]
    bpp = CHANNELS[ctype] * depth // 8
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int32)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        x, kind = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = png.chunk(b"IHDR", header)
    if palette is not None:
        body += png.chunk(b"PLTE", palette.tobytes())
    return png.SIGNATURE + body + png.chunk(b"IDAT", zlib.compress(b"".join(out))) + png.chunk(b"IEND", b"")


def pil(data):
    return Image.open(bytes_io.BytesIO(data))


def row_filters(data):
    """The filter byte of every row of an 8-bit RGB file."""
    d = png.decode(data)
    raw = b"".join(body for tag, body in png._chunks(data) if tag == b"IDAT")
    stride = d.samples.shape[1] * 3 + 1
    return set(np.frombuffer(zlib.decompress(raw), np.uint8)[::stride].tolist())


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

CODEC_CASES = [(0, 8), (0, 16), (2, 8), (2, 16), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", CODEC_CASES)
def test_decode_matches_pil_on_every_filter(ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    shape = (11, 13) if CHANNELS[ctype] == 1 else (11, 13, CHANNELS[ctype])
    a = rng.integers(0, 1 << depth, shape).astype(np.uint8 if depth == 8 else np.uint16)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8) if ctype == 3 else None
    f = write_filtered(a, ctype, depth, palette)
    got = png.decode(f)
    np.testing.assert_array_equal(got.samples, a)
    want = np.asarray(pil(f))
    assert got.array().dtype == want.dtype
    np.testing.assert_array_equal(got.array(), want)
    np.testing.assert_array_equal(got.rgb(), np.asarray(pil(f).convert("RGB")))


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA", "LA", "P"])
def test_decode_matches_pil_on_pil_written_files(mode):
    rng = np.random.default_rng(7)
    smooth = np.add.outer(np.arange(40), np.arange(56))
    if mode == "I;16":
        img = Image.fromarray((rng.random((40, 56)) * 65535).astype(np.uint16))
    elif mode == "P":
        img = Image.fromarray((smooth % 256).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    else:
        n = len(mode)
        noise = (rng.random((40, 56, n)) * 255).astype(np.uint8)
        noise[20:] = (smooth[20:, :, None] * np.arange(1, n + 1)) % 256  # smooth rows take other filters
        img = Image.fromarray(noise[:, :, 0] if n == 1 else noise, mode)
    buf = bytes_io.BytesIO()
    img.save(buf, format="PNG")
    got = png.decode(buf.getvalue())
    want = pil(buf.getvalue())
    np.testing.assert_array_equal(got.array(), np.asarray(want))
    np.testing.assert_array_equal(got.rgb(), np.asarray(want.convert("RGB")))


def test_pil_adaptive_filters_reach_the_vectorised_and_looped_unfilters():
    rng = np.random.default_rng(0)
    noise = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    noise[32:] = np.fromfunction(lambda i, j, c: (i * 3 + j * 2 + c * 40) % 256, (32, 80, 3))
    buf = bytes_io.BytesIO()
    Image.fromarray(noise).save(buf, format="PNG")
    assert {1, 2, 4} <= row_filters(buf.getvalue())  # Sub, Up, Paeth chosen by PIL
    np.testing.assert_array_equal(png.decode(buf.getvalue()).samples, noise)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (9, 14, 3)), (np.uint8, (9, 14)), (np.uint16, (9, 14))])
def test_encode_round_trips_through_pil(tmp_path, dtype, shape):
    a = np.random.default_rng(1).integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    png.write(tmp_path / "x.png", a)
    back = np.asarray(Image.open(tmp_path / "x.png"))
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(png.read(tmp_path / "x.png").samples, a)


def test_unreadable_files_raise_and_say_why():
    a = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(write_filtered(a, 2, 8, interlace=1))
    header = struct.pack(">IIBBBBB", 5, 4, 1, 0, 0, 0, 0)  # 1-bit greyscale
    one_bit = png.SIGNATURE + png.chunk(b"IHDR", header) + png.chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="colour type 0 .* bit depth 1"):
        png.decode(one_bit)
    good = bytearray(write_filtered(a, 2, 8))
    good[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="broken PNG chunk"):
        png.decode(bytes(good))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 5, 3), np.uint16))


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_io_functions_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(2)
    rgb = (rng.random((30, 41, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "rgb.png")
    for bgr in (True, False):
        got, want = io.load_rgb(str(tmp_path / "rgb.png"), bgr=bgr), jio.load_rgb(str(tmp_path / "rgb.png"), bgr=bgr)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    grey = (rng.random((30, 41)) * 255).astype(np.uint8)  # a greyscale frame read as RGB
    Image.fromarray(grey).save(tmp_path / "grey.png")
    np.testing.assert_array_equal(io.load_rgb(str(tmp_path / "grey.png")), jio.load_rgb(str(tmp_path / "grey.png")))

    depth = (rng.random((30, 41)) * 90).astype(np.float32)
    depth[0, :3] = [-1.0, 300.0, np.float32(1 / 256)]  # clipped below and above
    io.save_depth_png16(str(tmp_path / "port.png"), depth)
    jio.save_depth_png16(str(tmp_path / "jax.png"), depth)
    for p in ("port.png", "jax.png"):
        got, want = io.load_depth_png16(str(tmp_path / p)), jio.load_depth_png16(str(tmp_path / p))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(io.load_validity_map_png16(str(tmp_path / p)),
                                      jio.load_validity_map_png16(str(tmp_path / p)))
    np.testing.assert_array_equal(io.load_depth_png16(str(tmp_path / "port.png")),
                                  jio.load_depth_png16(str(tmp_path / "jax.png")))

    np.save(tmp_path / "d.npy", rng.random(30 * 41))
    np.testing.assert_array_equal(io.load_npy_depth(str(tmp_path / "d.npy"), (30, 41)),
                                  jio.load_npy_depth(str(tmp_path / "d.npy"), (30, 41)))
    (tmp_path / "list.txt").write_text("a/b.png\n\n  c/d.png  \n")
    assert io.read_paths("/data", str(tmp_path / "list.txt")) == jio.read_paths("/data", str(tmp_path / "list.txt"))
    calib = tmp_path / "calib_cam_to_cam.txt"
    calib.write_text("calib_time: 09-Jan-2012 13:57:47\nno colon here\n"
                     + "".join(f"P_rect_0{c}: " + " ".join(str(0.5 * i + c) for i in range(12)) + "\n"
                               for c in (2, 3)))
    got, want = io.read_calib_file(str(calib)), jio.read_calib_file(str(calib))
    assert got.keys() == want.keys() == {"P_rect_02", "P_rect_03"}
    for cam in ("image_02", "image_03"):
        k = io.kitti_intrinsics(got, cam)
        assert k.dtype == np.float32
        np.testing.assert_array_equal(k, jio.kitti_intrinsics(want, cam))
    with pytest.raises(ValueError, match="Unknown camera"):
        io.kitti_intrinsics(got, "image_05")


# ---------------------------------------------------------------------------
# sparsify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((7, 9), (480, 640)), ((480, 640), (7, 11)), ((37, 53), (480, 640)),
                                     ((480, 640), (353, 1217)), ((375, 1242), (480, 640)),
                                     ((101, 103), (97, 1013))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_mask_nearest_is_pils(src, dst, dtype):
    mask = (np.random.default_rng(src[0]).random(src) < 0.3).astype(dtype)
    got, want = sparsify.resize_mask_nearest(mask, dst), jsparsify.resize_mask_nearest(mask, dst)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sparsifiers_equal_the_jax_packages_for_one_seed():
    rng = np.random.default_rng(4)
    depth = (rng.random((40, 56)) * 6).astype(np.float32)
    depth[10:22, 12:30] += 4  # edges for the Sobel map
    masks = [(rng.random((20, 28)) < 0.3).astype(np.float32), (rng.random((40, 56)) < 0.2).astype(np.float32)]
    cases = [
        ("apply_mask_pool", lambda m, g: m.apply_mask_pool(depth, masks, g)),
        ("apply_mask_pool, one mask", lambda m, g: m.apply_mask_pool(depth, masks[0], g)),
        ("drop_random_points", lambda m, g: m.drop_random_points(depth, 700, g)),
        ("add_multiplicative_noise", lambda m, g: m.add_multiplicative_noise(depth, g)),
        ("add_multiplicative_noise 0.3", lambda m, g: m.add_multiplicative_noise(depth, g, fraction=0.3,
                                                                                  amplitude=0.2)),
        ("sobel_edge_map", lambda m, g: m.sobel_edge_map(depth, 0.5)),
        ("inpaint_with_nearest", lambda m, g: m.inpaint_with_nearest(depth, m.sobel_edge_map(depth), 3)),
        ("edge_inpaint", lambda m, g: m.edge_inpaint(depth)),
    ]
    for name, fn in cases:
        for seed in (0, 1):
            ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = fn(sparsify, ga), fn(jsparsify, gb)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert ga.random() == gb.random(), name  # the same draws, in the same order


# ---------------------------------------------------------------------------
# dataset readers, on trees built as tests/test_data.py builds them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu")
    for sub in ["train/gt", "train/depth", "train/img", "test/depth", "test/img", "mask"]:
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(3):
        gt = (rng.random((480, 640)) * 8).astype(np.float32)
        np.save(root / "train/gt" / f"{i:04d}.npy", gt)
        np.save(root / "train/depth" / f"{i:04d}.npy", gt * 0.5)
        img = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train/img" / f"{i:04d}.png")
    for i in range(2):
        np.save(root / "test/depth" / f"{i}.npy", rng.random((480, 640)).astype(np.float32))
        Image.fromarray((rng.random((480, 640, 3)) * 255).astype(np.uint8)).save(root / "test/img" / f"{i}.png")
    np.save(root / "mask" / "m0.npy", (rng.random((480, 640)) < 0.2).astype(np.float32))
    np.save(root / "mask" / "m1.npy", (rng.random((240, 320)) < 0.2).astype(np.float32))  # resized
    return str(root)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    drive, day = "2011_09_26_drive_0001_sync", "2011_09_26"
    gt_dir = root / "data_depth_annotated/train" / drive / "proj_depth/groundtruth" / "image_02"
    li_dir = root / "data_depth_velodyne/train" / drive / "proj_depth/velodyne_raw" / "image_02"
    rgb_dir = root / "raw" / day / drive / "image_02" / "data"
    for d in [gt_dir, li_dir, rgb_dir]:
        d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i in range(2):
        name = f"{i:010d}.png"
        depth = (rng.random((375, 1242)) * 60).astype(np.float32)
        jio.save_depth_png16(str(gt_dir / name), depth)
        jio.save_depth_png16(str(li_dir / name), depth * (rng.random((375, 1242)) < 0.07))
        Image.fromarray((rng.random((375, 1242, 3)) * 255).astype(np.uint8)).save(rgb_dir / name)
    with open(root / "raw" / day / "calib_cam_to_cam.txt", "w") as f:
        p = [721.5, 0.0, 609.6, 44.9, 0.0, 721.5, 172.9, 0.2, 0.0, 0.0, 1.0, 0.003]
        f.write("P_rect_02: " + " ".join(map(str, p)) + "\n")
        f.write("P_rect_03: " + " ".join(map(str, p)) + "\n")

    k_txt = "721.5 0.0 609.6 0.0 721.5 172.9 0.0 0.0 1.0"
    sel = root / "val_selection_cropped"
    for sub in ("groundtruth_depth", "velodyne_raw", "image", "intrinsics"):
        (sel / sub).mkdir(parents=True)
    test = root / "test_depth_completion_anonymous"
    for sub in ("velodyne_raw", "image", "intrinsics"):
        (test / sub).mkdir(parents=True)
    for i in range(2):
        name = f"2011_09_26_drive_0002_sync_image_{i:010d}_image_02"
        depth = (rng.random((352, 1216)) * 60).astype(np.float32)
        jio.save_depth_png16(str(sel / "groundtruth_depth" / f"{name}.png"), depth)
        jio.save_depth_png16(str(sel / "velodyne_raw" / f"{name}.png"), depth * (rng.random((352, 1216)) < 0.07))
        Image.fromarray((rng.random((352, 1216, 3)) * 255).astype(np.uint8)).save(sel / "image" / f"{name}.png")
        (sel / "intrinsics" / f"{name}.txt").write_text(k_txt)
        name = f"{i:010d}"
        jio.save_depth_png16(str(test / "velodyne_raw" / f"{name}.png"), depth * (rng.random((352, 1216)) < 0.07))
        Image.fromarray((rng.random((352, 1216, 3)) * 255).astype(np.uint8)).save(test / "image" / f"{name}.png")
        (test / "intrinsics" / f"{name}.txt").write_text(k_txt)
    return str(root)


@pytest.fixture(scope="module")
def void_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("void")
    base = root / "void_1500"
    seq = base / "data" / "seq0"
    kinds = ["image", "sparse_depth", "ground_truth", "absolute_pose", "intrinsics"]
    for sub in kinds:
        (seq / sub).mkdir(parents=True)
    (base / "mask").mkdir(parents=True)
    rng = np.random.default_rng(3)
    manifests = {k: [] for k in kinds}
    for i in range(2):
        name = f"{i:04d}"
        Image.fromarray((rng.random((480, 640, 3)) * 255).astype(np.uint8)).save(seq / "image" / f"{name}.png")
        gt = (rng.random((480, 640)) * 5).astype(np.float32)
        jio.save_depth_png16(str(seq / "ground_truth" / f"{name}.png"), gt)
        jio.save_depth_png16(str(seq / "sparse_depth" / f"{name}.png"), gt * (rng.random((480, 640)) < 0.01))
        np.savetxt(seq / "absolute_pose" / f"{name}.txt", rng.random((4, 4)))
        np.savetxt(seq / "intrinsics" / f"{name}.txt", rng.random((3, 3)))
        for k in manifests:
            ext = "txt" if k in ("absolute_pose", "intrinsics") else "png"
            manifests[k].append(f"void_1500/data/seq0/{k}/{name}.{ext}")
    for k, lines in manifests.items():
        (base / f"train_{k}.txt").write_text("\n".join(lines))
    np.save(base / "mask" / "m0.npy", (rng.random((480, 640)) < 0.3).astype(np.float32))
    np.save(base / "mask" / "m1.npy", (rng.random((480, 640)) < 0.1).astype(np.float32))
    return str(root)


def assert_items_equal(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in list(range(len(jax_ds))) + [0]:  # a second read of item 0 draws anew
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, (i, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"item {i} {k}")


DATASETS = [
    ("nyu", "NYUDataset", dict(mode="train")),
    ("nyu", "NYUDataset", dict(mode="train", use_mask=False, add_noise=True, seed=5)),
    ("nyu", "NYUDataset", dict(mode="train", add_noise=True, sparse_source="lidar", height=448, width=608)),
    ("nyu", "NYUTestDataset", dict()),
    ("kitti", "KITTIDataset", dict(mode="train")),
    ("kitti", "KITTISelValDataset", dict()),
    ("kitti", "KITTITestDataset", dict()),
    ("void", "VOIDDataset", dict(mode="train")),
    ("void", "VOIDDataset", dict(mode="train", use_mask=False, edge_inpainting=False)),
]


@pytest.mark.parametrize("tree,cls,kw", DATASETS, ids=[f"{c}-{i}" for i, (_, c, _) in enumerate(DATASETS)])
def test_dataset_items_equal_the_jax_packages(request, tree, cls, kw):
    root = request.getfixturevalue(f"{tree}_root")
    assert_items_equal(getattr(data, cls)(root, **kw), getattr(jdata, cls)(root, **kw))


def test_crop_top_center_equals_the_jax_packages():
    img = np.random.default_rng(0).random((20, 30, 3)).astype(np.float32)
    k = np.array([[100.0, 0, 15], [0, 100, 10], [0, 0, 1]], np.float32)
    (got,), kg = data.crop_top_center([img], k, 16, 24)
    (want,), kw = jdata.crop_top_center([img], k, 16, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kg, kw)
    assert k[0, 2] == 15  # input not mutated
    np.testing.assert_array_equal(data.NYU_K, jdata.NYU_K)
    np.testing.assert_array_equal(data.NYU_TEST_K, jdata.NYU_TEST_K)
