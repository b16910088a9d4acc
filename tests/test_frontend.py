"""Front-end tests: FAST detection recall on rendered fiducials, descriptor
repeatability, matmul-Hamming == popcount-Hamming, stereo depth accuracy.
Mirrors what the reference gets from OpenCV (stereo.rs) but validated against
a synthetic world with exact ground truth.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import Features, OrbConfig, detect_orb
from orbslam3_tpu.frontend.stereo import StereoConfig, match_stereo, process_stereo
from orbslam3_tpu.geometry import quat
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.ops import fast as fast_ops
from orbslam3_tpu.ops.brief import pack_bits, unpack_bits
from orbslam3_tpu.ops.hamming import hamming_matrix, hamming_matrix_popcount

CFG = SyntheticConfig(width=384, height=256, n_landmarks=400, duration=2.0, fx=240.0, fy=240.0)
ORB = OrbConfig(n_features=384, n_levels=4)


def _fast_nms_numpy(img, thr_hi, thr_lo):
    """NumPy FAST-16-9 + dual threshold + 3x3 NMS, written pixel-window
    by pixel-window (edge-replicated shifts, left-to-right f32 sums)."""
    h, w = img.shape

    def shift(dy, dx):
        ys = np.clip(np.arange(h) + dy, 0, h - 1)
        xs = np.clip(np.arange(w) + dx, 0, w - 1)
        return img[ys][:, xs]

    diffs = [shift(int(dy), int(dx)) - img for dy, dx in fast_ops.CIRCLE]

    def score(thr):
        def seg9(masks):
            m = np.stack(masks + masks[:8])  # circular
            return np.any([m[s:s + 9].all(0) for s in range(16)], axis=0)

        corner = seg9([d > thr for d in diffs]) | seg9([d < -thr for d in diffs])
        sb = np.zeros_like(img)
        sd = np.zeros_like(img)
        for d in diffs:
            sb = sb + np.maximum(d - np.float32(thr), np.float32(0))
            sd = sd + np.maximum(-d - np.float32(thr), np.float32(0))
        return np.where(corner, np.maximum(sb, sd), np.float32(0))

    s = np.maximum(score(thr_hi), score(thr_lo) * np.float32(1e-3))
    p = np.pad(s, 1, constant_values=-np.inf)
    mx = np.max([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                axis=0)
    return np.where(s >= mx, s, np.float32(0))


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld(CFG)


@pytest.fixture(scope="module")
def frame0(world):
    return world.render_frame(0.0)


class TestFast:
    def test_synthetic_corner(self):
        """A bright square on dark background has corners at its 4 corners."""
        img = np.zeros((64, 64), np.float32)
        img[24:40, 24:40] = 1.0
        score = fast_ops.fast_score(jnp.asarray(img), 0.2)
        s = np.asarray(score)
        # corner pixels (inside the square, adjacent to two edges) must fire
        assert s[25, 25] > 0 or s[24, 24] > 0
        # flat regions and straight edges must not
        assert s[32, 32] == 0  # center (flat bright)
        assert s[5, 5] == 0  # flat dark
        assert s[24, 32] == 0  # mid-edge

    def test_fast_nms_matches_numpy_reference(self):
        """The plain FAST+NMS path (the detector's only one) equals a NumPy
        reference bit for bit on every pyramid level of a 752x480 frame."""
        from orbslam3_tpu.frontend.orb import _score_maps_batched
        from orbslam3_tpu.ops.pyramid import build_pyramid

        w = SyntheticWorld(SyntheticConfig(width=752, height=480,
                                           n_landmarks=800, texture="textured"))
        left, _ = w.render_frame(0.0)
        cfg = OrbConfig()
        img = jnp.asarray(left.astype(np.uint8), jnp.float32)
        levels = [np.asarray(lv) for lv in build_pyramid(img, cfg.n_levels,
                                                          cfg.scale_factor)]
        got = _score_maps_batched([jnp.asarray(lv)[None] for lv in levels], cfg)
        assert len(levels) == 8
        for lv, s in zip(levels, got):
            want = _fast_nms_numpy(lv, cfg.fast_threshold, cfg.fast_threshold_min)
            np.testing.assert_array_equal(np.asarray(s[0]), want)
            assert (want > 0).sum() > 0

    def test_nms_keeps_single_peak(self):
        score = np.zeros((32, 32), np.float32)
        score[10, 10] = 5.0
        score[10, 11] = 4.0  # neighbor suppressed
        out = np.asarray(fast_ops.nms3x3(jnp.asarray(score)))
        assert out[10, 10] == 5.0
        assert out[10, 11] == 0.0

    def test_select_keypoints_shapes(self):
        score = np.random.default_rng(0).uniform(0, 1, (128, 128)).astype(np.float32)
        ys, xs, v = fast_ops.select_keypoints(jnp.asarray(score), cell=32, k_cell=2, n_out=16)
        assert ys.shape == xs.shape == v.shape == (16,)
        # cell cap: no more than 2 from any 32x32 cell
        cells = {}
        for y, x in zip(np.asarray(ys), np.asarray(xs)):
            c = (y // 32, x // 32)
            cells[c] = cells.get(c, 0) + 1
        assert max(cells.values()) <= 2


class TestDetect:
    def test_detection_recall(self, world, frame0):
        """>=40% of well-visible landmark centers get a keypoint within 3 px."""
        left, _ = frame0
        feat = detect_orb(jnp.asarray(left), ORB)
        uv = np.asarray(feat.uv)[np.asarray(feat.valid)]
        assert len(uv) > 100

        q, p = world.gt_pose(0.0)
        xc = np.asarray(
            quat.rotate(quat.conj(jnp.asarray(q))[None], jnp.asarray(world.landmarks - p[None]))
        )
        z = xc[:, 2]
        pr = np.stack(
            [CFG.fx * xc[:, 0] / z + CFG.width / 2, CFG.fy * xc[:, 1] / z + CFG.height / 2], -1
        )
        vis = (z > 0.5) & (z < 8.0) & (pr[:, 0] > 30) & (pr[:, 0] < CFG.width - 30) & (pr[:, 1] > 30) & (pr[:, 1] < CFG.height - 30)
        centers = pr[vis]
        if len(centers) == 0:
            pytest.skip("no visible landmarks at t=0")
        d = np.linalg.norm(centers[:, None] - uv[None], axis=-1).min(axis=1)
        recall = (d < 3.0).mean()
        assert recall > 0.4, f"recall {recall:.2f}, {len(centers)} visible"

    def test_descriptor_determinism(self, frame0):
        left, _ = frame0
        f1 = detect_orb(jnp.asarray(left), ORB)
        f2 = detect_orb(jnp.asarray(left), ORB)
        np.testing.assert_array_equal(np.asarray(f1.desc), np.asarray(f2.desc))


class TestHamming:
    def test_matmul_equals_popcount(self):
        rng = np.random.default_rng(3)
        a = jnp.asarray(rng.integers(0, 256, (64, 32)), jnp.uint8)
        b = jnp.asarray(rng.integers(0, 256, (96, 32)), jnp.uint8)
        np.testing.assert_array_equal(
            np.asarray(hamming_matrix(a, b)), np.asarray(hamming_matrix_popcount(a, b))
        )

    def test_pack_unpack_roundtrip(self):
        rng = np.random.default_rng(4)
        bits = jnp.asarray(rng.integers(0, 2, (8, 256)), jnp.uint8)
        np.testing.assert_array_equal(np.asarray(unpack_bits(pack_bits(bits))), np.asarray(bits))


class TestStereo:
    def test_depth_accuracy(self, world, frame0):
        """Matched stereo features recover metric depth within 5%."""
        left, right = frame0
        cam = world.cam
        sf = process_stereo(jnp.asarray(left), jnp.asarray(right), cam, ORB)
        has = np.asarray(sf.has_depth)
        assert has.sum() > 50, f"only {has.sum()} stereo matches"

        # true depth at each matched keypoint = depth of nearest landmark proj
        q, p = world.gt_pose(0.0)
        xc = np.asarray(
            quat.rotate(quat.conj(jnp.asarray(q))[None], jnp.asarray(world.landmarks - p[None]))
        )
        z = xc[:, 2]
        ok = z > 0.3
        pr = np.stack(
            [CFG.fx * xc[:, 0] / np.maximum(z, 1e-6) + CFG.width / 2,
             CFG.fy * xc[:, 1] / np.maximum(z, 1e-6) + CFG.height / 2], -1
        )
        uv = np.asarray(sf.feat.uv)[has]
        depth = np.asarray(sf.depth)[has]
        d = np.linalg.norm(pr[ok][:, None] - uv[None], axis=-1)
        nearest = d.argmin(axis=0)
        close = d.min(axis=0) < 3.0
        rel_err = np.abs(depth[close] - z[ok][nearest[close]]) / z[ok][nearest[close]]
        assert close.sum() > 30
        assert np.median(rel_err) < 0.05, f"median depth err {np.median(rel_err):.3f}"
