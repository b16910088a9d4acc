"""Measure DBoW2 L1-score discriminativeness on the textured world:
does a genuine revisit outscore aliased views, and does the reference's
min-covisible-score gate (bow_min_score_gate) keep the genuine candidate?

Usage: python scripts/probe_bow_gate.py  (GPU or CPU)
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
from orbslam3_tpu.utils import compile_cache
compile_cache.enable()
import jax.numpy as jnp

from bench import HARD_WORLD, train_world_vocab
from orbslam3_tpu.frontend.orb import OrbConfig, detect_orb
from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu.loop import vocab as vb

# revisit-style trajectory: full pan every 16 s -> t and t+16 see the
# same view; t+4/t+8 see other walls
cfg = SyntheticConfig(
    duration=24.0, n_landmarks=1500, seed=7,
    yaw_amp=0.0, yaw_rate=2 * np.pi / 16.0,
    pos_freq=(0.125, 0.1875, 0.25),
    **HARD_WORLD,
)
world = SyntheticWorld(cfg)
ts = [0.5, 1.0, 2.0, 3.0]
frames = {}
for t0 in ts:
    for dt in (0.0, 4.0, 8.0, 12.0, 16.0):
        t = t0 + dt
        if t not in frames:
            frames[t] = world.render_frame(t)[0]

voc = train_world_vocab(world, [(f, f) for f in [frames[t] for t in sorted(frames)]])
oc = OrbConfig()

def bow(t):
    f = detect_orb(jnp.asarray(frames[t].astype(np.float32)), oc)
    ids, w, _ = vb.transform_sparse(voc, f.desc, f.valid)
    return ids, w

rows = []
for t0 in ts:
    i0 = bow(t0)
    scores = {}
    for dt in (4.0, 8.0, 12.0, 16.0):
        i1 = bow(t0 + dt)
        s = vb.score_sparse_many(voc, i0[0], i0[1], i1[0][None], i1[1][None])
        scores[dt] = float(s[0])
    rows.append((t0, scores))
    print(f"t0={t0}: revisit(dt16)={scores[16.0]:.4f} vs other views "
          f"dt4={scores[4.0]:.4f} dt8={scores[8.0]:.4f} dt12={scores[12.0]:.4f}")

ok = sum(r[1][16.0] > max(r[1][4.0], r[1][8.0], r[1][12.0]) for r in rows)
print(f"revisit ranked first in {ok}/{len(rows)} cases")
