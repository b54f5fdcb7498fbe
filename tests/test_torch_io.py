"""The port's dataset layer against the JAX package and PIL, on the CPU.

  * io/png.py: PIL-written 8-bit grey, RGB, RGBA and 16-bit grey files
    decode equal to PIL's arrays, and RGB(A) converts to grey equal to
    PIL's convert("L") (bit for bit); the port's files decode equal in
    PIL; every row filter (None, Sub, Up, Average, Paeth) decodes exactly,
    in files whose rows cycle through all five; the port's writer picks
    among all five; palette, grey + alpha, 1-bit and interlaced files raise
    ValueError, as do a corrupt one and an unknown row filter.
  * io/datasets.py: TumRgbdDataset (lists, and an association file),
    KittiOdometryDataset, EurocDataset (root and explicit directories) and
    RectifiedStereoDataset against their JAX twins on the same directories
    (PIL-written files): arrays and timestamps equal, bit for bit.
  * evaluation/gt_eval.py (the three loaders, discover_ground_truth,
    _associate, evaluate_against_gt) and ops/rectify.py (maps, remap,
    has_rectification, StereoRectifier) against the JAX package: the same
    numpy arithmetic, so equal bit for bit.
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from orb_slam2_detailed_comments_tpu.evaluation import gt_eval as JG
from orb_slam2_detailed_comments_tpu.io import datasets as JD
from orb_slam2_detailed_comments_tpu.ops import rectify as JR

from orb_slam2_detailed_comments_tpu_torch.evaluation import gt_eval as TG
from orb_slam2_detailed_comments_tpu_torch.io import datasets as TD
from orb_slam2_detailed_comments_tpu_torch.io.png import read_png, row_filters, to_gray, write_png
from orb_slam2_detailed_comments_tpu_torch.ops import rectify as TR
from orb_slam2_detailed_comments_tpu_torch.utils.config import load_settings_raw

from test_rectify import EUROC_SNIPPET

H, W = 24, 37


def _image(seed, shape, dtype=np.uint8):
    """A smooth ramp plus noise: rows where every filter predicts well."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    ramp = np.linspace(0, hi * 0.8, shape[1])[None, :]
    ramp = ramp.reshape((1, shape[1]) + (1,) * (len(shape) - 2))
    noise = rng.integers(0, max(hi // 20, 2), shape)
    return np.clip(ramp + noise, 0, hi).astype(dtype)


def _png_bytes(rows, width, ctype, depth, filters, interlace=0):
    """A PNG of the given raw pixel rows, each row filtered with the next
    filter type of `filters` (0-4, cycled)."""
    stride = rows.shape[1]
    bpp = stride // width
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, rows.shape[0], depth, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


MODES = {  # name: (PIL mode, shape, dtype)
    "grey8": ("L", (H, W), np.uint8),
    "rgb8": ("RGB", (H, W, 3), np.uint8),
    "rgba8": ("RGBA", (H, W, 4), np.uint8),
    "grey16": ("I;16", (H, W), np.uint16),
}


@pytest.mark.parametrize("name", sorted(MODES))
def test_pil_written_files_decode_as_pil_reads_them(name, tmp_path):
    mode, shape, dtype = MODES[name]
    img = _image(1, shape, dtype)
    path = str(tmp_path / "a.png")
    Image.fromarray(img, None if dtype == np.uint16 else mode).save(path)
    got = read_png(path)
    pil = Image.open(path)
    assert got.dtype == dtype and np.array_equal(got, np.asarray(pil))
    if img.ndim == 3:
        # ITU-R 601-2 in PIL's integer form, bit for bit
        assert np.array_equal(to_gray(got), np.asarray(pil.convert("L")))


@pytest.mark.parametrize("name", ["grey8", "rgb8", "grey16"])
def test_port_written_files_decode_in_pil(name, tmp_path):
    _, shape, dtype = MODES[name]
    img = _image(2, shape, dtype)
    path = str(tmp_path / "b.png")
    write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert np.array_equal(read_png(path), img)


@pytest.mark.parametrize("name", sorted(MODES))
def test_every_row_filter_decodes(name, tmp_path):
    """Rows cycle through the five filters, in two orders (so every filter
    follows every other on some row)."""
    _, shape, dtype = MODES[name]
    img = _image(3, shape, dtype)
    ctype = {2: 0, 3: {3: 2, 4: 6}[shape[-1]] if len(shape) == 3 else 0}[len(shape)]
    depth = 16 if dtype == np.uint16 else 8
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(H, -1)
    for k, filters in enumerate(([0, 1, 2, 3, 4], [4, 2, 0, 3, 1, 4, 4, 3, 3])):
        path = tmp_path / f"f{k}.png"
        path.write_bytes(_png_bytes(rows, W, ctype, depth, filters))
        assert np.array_equal(np.asarray(Image.open(path)), img)
        assert np.array_equal(read_png(str(path)), img)


def test_writer_picks_among_all_five_filters(tmp_path):
    """Coarse texture on a ramp: the writer's per-row choice (libpng's
    heuristic) takes every one of the five filters somewhere, so files it
    writes exercise the serial Average and Paeth decoding as other writers'
    files do."""
    rng = np.random.default_rng(5)
    img = (rng.integers(0, 255, (120, 400)) // 8 * 8
           + np.linspace(0, 50, 400)[None, :]).astype(np.uint8)
    path = str(tmp_path / "mix.png")
    write_png(path, img)
    assert (row_filters(path) > 0).all(), row_filters(path)
    assert np.array_equal(read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)


def test_unsupported_and_corrupt_files_raise(tmp_path):
    img = _image(4, (H, W))
    Image.fromarray(img, "L").convert("P").save(tmp_path / "palette.png")
    Image.fromarray(np.stack([img, img], -1), "LA").save(tmp_path / "grey_alpha.png")
    Image.fromarray(img > 128).save(tmp_path / "bit.png")
    (tmp_path / "interlaced.png").write_bytes(_png_bytes(img, W, 0, 8, [0], interlace=1))
    good = _png_bytes(img, W, 0, 8, [1])
    bad = bytearray(good)
    bad[45] ^= 0xFF     # inside the IDAT payload: its CRC no longer matches
    (tmp_path / "corrupt.png").write_bytes(bytes(bad))
    (tmp_path / "truncated.png").write_bytes(good[:60])
    (tmp_path / "badfilter.png").write_bytes(_png_bytes(img, W, 0, 8, [0, 5]))
    for name in ("palette", "grey_alpha", "bit", "interlaced", "corrupt", "truncated",
                 "badfilter"):
        path = str(tmp_path / f"{name}.png")
        with pytest.raises(ValueError, match=name):
            read_png(path)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "f.png"), img.astype(np.float32))


# ---------------------------------------------------------------------------
# dataset loaders against the JAX package's on the same directories
# ---------------------------------------------------------------------------

def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype == np.float32 and np.array_equal(u, v)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A TUM RGB-D layout written by PIL: RGB colour frames, 16-bit depth
    stamped 4-7 ms after them (one frame has no depth within 20 ms), an
    association file and ground truth."""
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb, depth, assoc, gt = [], [], [], []
    for i in range(4):
        ts = 1305031102.0 + i / 30
        td = ts + 0.004 + 0.001 * i + (0.05 if i == 2 else 0.0)
        Image.fromarray(_image(10 + i, (H, W, 3)), "RGB").save(root / "rgb" / f"{ts:.6f}.png")
        Image.fromarray(_image(20 + i, (H, W), np.uint16)).save(
            root / "depth" / f"{td:.6f}.png")
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png\n")
        depth.append(f"{td:.6f} depth/{td:.6f}.png\n")
        assoc.append(f"{ts:.6f} rgb/{ts:.6f}.png {td:.6f} depth/{td:.6f}.png\n")
        gt.append(f"{ts + 0.002:.6f} {0.1 * i} 0.2 {0.05 * i} 0.0 0.0 {0.01 * i} 1.0\n")
    (root / "rgb.txt").write_text("# colour\n" + "".join(rgb))
    (root / "depth.txt").write_text("# depth\n" + "".join(depth))
    (root / "assoc.txt").write_text("".join(assoc))
    (root / "groundtruth.txt").write_text("# ts tx ty tz qx qy qz qw\n" + "".join(gt))
    return root


def test_tum_dataset_matches_jax(tum_dir):
    t, j = TD.TumRgbdDataset(str(tum_dir)), JD.TumRgbdDataset(str(tum_dir))
    assert t.pairs == j.pairs and t.pairs[2][2] is None
    _same_items(t, j)
    assert np.array_equal(t.groundtruth(), j.groundtruth())
    kw = dict(associations=str(tum_dir / "assoc.txt"), depth_factor=1000.0)
    _same_items(TD.TumRgbdDataset(str(tum_dir), **kw), JD.TumRgbdDataset(str(tum_dir), **kw))


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    for cam in ("image_0", "image_1"):
        (root / cam).mkdir()
        for i in range(3):
            Image.fromarray(_image(30 + i + 5 * (cam == "image_1"), (H, W)), "L").save(
                root / cam / f"{i:06d}.png")
    (root / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(3)))
    return root


@pytest.mark.parametrize("stereo", [True, False])
def test_kitti_dataset_matches_jax(kitti_dir, stereo):
    _same_items(TD.KittiOdometryDataset(str(kitti_dir), stereo=stereo),
                JD.KittiOdometryDataset(str(kitti_dir), stereo=stereo))


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    """A EuRoC MAV directory at the calibration's 752x480 (grey frames,
    nanosecond names) and a settings file with its LEFT./RIGHT. blocks."""
    root = tmp_path_factory.mktemp("euroc")
    names = [str(1403636579763555584 + 50000000 * i) for i in range(2)]
    for cam in ("cam0", "cam1"):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for k, n in enumerate(names):
            Image.fromarray(_image(40 + k + 3 * (cam == "cam1"), (480, 752)), "L").save(
                d / f"{n}.png")
    (root / "times.txt").write_text("".join(n + "\n" for n in names))
    (root / "settings.yaml").write_text(EUROC_SNIPPET)
    return root


def test_euroc_datasets_match_jax(euroc_dir):
    _same_items(TD.EurocDataset(str(euroc_dir), stereo=True),
                JD.EurocDataset(str(euroc_dir), stereo=True))
    cam = euroc_dir / "mav0"
    kw = dict(cam0_dir=str(cam / "cam0" / "data"), cam1_dir=str(cam / "cam1" / "data"),
              timestamps_file=str(euroc_dir / "times.txt"), stereo=True)
    t, j = TD.EurocDataset(**kw), JD.EurocDataset(**kw)
    _same_items(t, j)
    raw = load_settings_raw(str(euroc_dir / "settings.yaml"))
    _same_items(TD.RectifiedStereoDataset(t, TR.StereoRectifier.from_settings(raw)),
                JD.RectifiedStereoDataset(j, JR.StereoRectifier.from_settings(raw)))


def test_image_loaders_match_jax(tum_dir, kitti_dir):
    for p in sorted((tum_dir / "rgb").iterdir())[:1] + sorted((kitti_dir / "image_0").iterdir())[:1]:
        assert np.array_equal(TD.load_image_gray(str(p)), JD.load_image_gray(str(p)))
    for p in sorted((tum_dir / "depth").iterdir())[:1]:
        # a 16-bit image saturates at 255 in grey; in metres it is scaled
        assert np.array_equal(TD.load_image_gray(str(p)), JD.load_image_gray(str(p)))
        assert np.array_equal(TD.load_depth_png(str(p)), JD.load_depth_png(str(p)))


# ---------------------------------------------------------------------------
# ground-truth evaluation and rectification against the JAX package
# ---------------------------------------------------------------------------

def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 0.05 * i + rng.normal(0, 0.01)
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        T[:3, 3] = [0.1 * i, rng.normal(0, 0.01), 0.02 * i]
        out.append(T)
    return out


def test_gt_eval_matches_jax(tmp_path, tum_dir):
    # KITTI: <root>/poses/<nn>.txt beside <root>/sequences/<nn>; EuRoC csv
    seq = tmp_path / "sequences" / "07"
    seq.mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    gt = _poses(12, 0)
    (tmp_path / "poses" / "07.txt").write_text("".join(
        " ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n" for T in gt))
    mav = tmp_path / "mav"
    (mav / "state_groundtruth_estimate0").mkdir(parents=True)
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "".join(
            f"{int(1e9 * (100 + 0.05 * i))},{T[0, 3]},{T[1, 3]},{T[2, 3]},0.99,0.01,0.1,0.02\n"
            for i, T in enumerate(gt)))
    cases = {"kitti-stereo": (seq, [0.1 * i for i in range(12)]),
             "euroc-mono": (mav, [100 + 0.05 * i + 0.003 for i in range(12)]),
             "tum-rgbd": (tum_dir, [1305031102.0 + i / 30 for i in range(4)])}
    for mode, (d, stamps) in cases.items():
        found = TG.discover_ground_truth(mode, str(d))
        assert found == JG.discover_ground_truth(mode, str(d)) and found is not None
        loader = {"kitti": "load_kitti_gt", "tum": "load_tum_gt", "euroc": "load_euroc_gt"}
        a, b = getattr(TG, loader[found[0]])(found[1]), getattr(JG, loader[found[0]])(found[1])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):      # (ts, T) or, for KITTI, T alone
            x, y = (x, y) if isinstance(x, tuple) else ((None, x), (None, y))
            assert x[0] == y[0] and np.array_equal(x[1], y[1])
        est = [(i, ts, np.linalg.inv(T @ _poses(1, 9)[0] if i % 3 else T).astype(np.float32))
               for i, (ts, T) in enumerate(zip(stamps, _poses(len(stamps), 1)))]
        for mono in (False, True):
            assert TG.evaluate_against_gt(mode, str(d), est, mono) == \
                JG.evaluate_against_gt(mode, str(d), est, mono)
    assert TG.discover_ground_truth("kitti-mono", str(tmp_path)) is None
    ts_a, ts_b = np.array([0.0, 0.1, 0.21, 0.5]), np.array([0.52, 0.005, 0.1, 0.3])
    for x, y in zip(TG._associate(ts_a, ts_b), JG._associate(ts_a, ts_b)):
        assert np.array_equal(x, y)


def test_rectify_matches_jax(euroc_dir):
    """Maps and remap bit for bit (the same float64/float32 numpy code)."""
    raw = load_settings_raw(str(euroc_dir / "settings.yaml"))
    assert TR.has_rectification(raw) and JR.has_rectification(raw)
    assert not TR.has_rectification({k: v for k, v in raw.items() if k != "RIGHT.P"})
    for s in ("LEFT", "RIGHT"):
        args = [raw[f"{s}.{k}"] for k in "KDRP"] + [(raw[f"{s}.width"], raw[f"{s}.height"])]
        for a, b in zip(TR.init_undistort_rectify_map(*args), JR.init_undistort_rectify_map(*args)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    t, j = TR.StereoRectifier.from_settings(raw), JR.StereoRectifier.from_settings(raw)
    img = _image(50, (480, 752)).astype(np.float32)
    for a, b in zip(t(img, img[::-1].copy()), j(img, img[::-1].copy())):
        assert np.array_equal(a, b)
    mx = np.array([[-1.0, 0.0, 3.5, 751.0, 751.5]], np.float32)
    my = np.array([[0.0, 0.25, 479.0, 2.0, 2.0]], np.float32)
    assert np.array_equal(TR.remap_bilinear(img, mx, my, 7.0), JR.remap_bilinear(img, mx, my, 7.0))
    with pytest.raises(KeyError):
        TR.StereoRectifier.from_settings({})
