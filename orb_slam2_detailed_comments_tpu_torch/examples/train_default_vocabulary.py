#!/usr/bin/env python
"""Train the default ORB vocabulary.

The port's twin of the JAX package's examples/train_default_vocabulary.py.
The reference always runs with a large offline-trained vocabulary
(reference: src/System.cc:78-94 loads ORBvoc.txt before anything else).
This tool extracts ORB descriptors from diverse rendered imagery (six
textured cylinder laps and six tilted-plane worlds, 320x240) through the
port's extraction (ops/orb.extract_orb: on a CUDA device one launch of the
FAST-pyramid and one of the ORB-descriptor kernel an image), trains the
same k-ary tree (DBoW2's shape, seed 1) and writes it as .npz, then
reports the BoW scores of adjacent against opposite views on a held-out
world.

The default output is the port's shipped vocabulary,
data/default_vocab.npz, a byte copy of the JAX package's, which every
anchor of the port was read with. The tool will not overwrite it unless
given --force: a retrained tree (the port's descriptors equal the JAX
package's on most keypoints, not all) moves those anchors.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.train_default_vocabulary \\
      [out.npz] [--k 10 --L 5] [--features 1000] [--force] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device, load_synthetic_world)

DEFAULT_OUT = str(Path(__file__).resolve().parents[1] / "data" / "default_vocab.npz")


def _extractor(features: int, device):
    """img (H, W) float32 numpy -> (descriptors (N, 8) uint32, valid (N,))."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy
    from orb_slam2_detailed_comments_tpu_torch.ops.orb import extract_orb
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig
    orb = OrbConfig(n_features=features, max_keypoints=1024)

    def extract(img):
        kp = extract_orb(torch.as_tensor(np.asarray(img, np.float32)).to(device), orb)
        return desc_to_numpy(kp.desc), kp.valid.cpu().numpy()
    return extract


def gather_descriptors(features=600, verbose=True, device="cuda"):
    """The training descriptors, (n, 8) uint32, in the JAX tool's order."""
    sw = load_synthetic_world()
    extract = _extractor(features, device)
    descs = []

    def grab(img):
        desc, valid = extract(img)
        descs.append(desc[valid])

    # cylinder laps: six textures, outward yaw sweeps the full 360 deg
    for seed in range(6):
        world = sw.CylinderWorld(fx=180.0, fy=180.0, cx=160.0, cy=120.0, width=320, height=240,
                                 radius=8.0, texture_seed=seed)
        for T in sw.loop_trajectory(24, path_radius=4.0, overlap=0):
            grab(world.render(T))
        if verbose:
            print(f"cylinder seed {seed}: {sum(map(len, descs))} descriptors", flush=True)

    # tilted-plane worlds: six textures, lateral sweeps
    for seed in range(10, 16):
        world = sw.PlanesWorld(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                               texture_seed=seed)
        for T in sw.smooth_trajectory(16, step=0.12, seed=seed):
            grab(world.render(T))
        if verbose:
            print(f"planes seed {seed}: {sum(map(len, descs))} descriptors", flush=True)
    return np.concatenate(descs, axis=0)


def held_out_scores(voc, device="cuda"):
    """Mean BoW score of adjacent and of opposite views on a held-out lap
    (texture seed 99, 16 views)."""
    from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary
    sw = load_synthetic_world()
    extract = _extractor(600, device)
    world = sw.CylinderWorld(fx=180.0, fy=180.0, cx=160.0, cy=120.0, width=320, height=240,
                             radius=8.0, texture_seed=99)
    bows = []
    for T in sw.loop_trajectory(16, path_radius=4.0, overlap=0):
        desc, valid = extract(world.render(T))
        bows.append(voc.transform(desc, valid)[1])
    same = [TreeVocabulary.score(bows[i], bows[(i + 1) % 16]) for i in range(16)]
    diff = [TreeVocabulary.score(bows[i], bows[(i + 8) % 16]) for i in range(16)]
    return float(np.mean(same)), float(np.mean(diff))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--force", action="store_true",
                    help="overwrite the shipped default vocabulary")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if (os.path.exists(args.out) and os.path.samefile(args.out, DEFAULT_OUT)
            and not args.force):
        raise SystemExit(f"{args.out} is the shipped vocabulary, which the port's anchors were "
                         "read with; give another path, or --force to overwrite it")
    device = check_device(args.device)

    from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary

    train = gather_descriptors(args.features, device=device)
    print(f"training k={args.k} L={args.L} on {len(train)} descriptors "
          f"({len(np.unique(train, axis=0))} unique)")
    voc = TreeVocabulary.train(train, k=args.k, L=args.L, seed=1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc.save(args.out)
    print(f"{voc.n_words} words -> {args.out} ({os.path.getsize(args.out) / 1024:.0f} KiB)")
    same, diff = held_out_scores(voc, device)
    print(f"held-out lap: adjacent-view score {same:.3f}, opposite-view {diff:.3f} "
          f"(ratio {same / max(diff, 1e-6):.1f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
