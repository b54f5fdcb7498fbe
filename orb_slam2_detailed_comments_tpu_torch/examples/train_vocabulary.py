#!/usr/bin/env python
"""Offline ORB vocabulary training — the missing half of the reference's
vocabulary workflow.

The reference ships a pre-trained 140 MB `ORBvoc.txt` and only LOADS it
(reference: src/System.cc:78-94; the training tool lives outside the repo
in DBoW2). For the reference's offline workflow — train once on
representative imagery, reuse across runs — this tool extracts ORB
descriptors from a dataset (ops/orb.extract_orb: on a CUDA device, one
launch of the FAST-pyramid and the ORB-descriptor kernels per image) and
trains either the flat vocabulary (default) or the DBoW2-style k-ary tree,
saving to .npz or the reference's ORBvoc text format.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.train_vocabulary \\
      <mode> <sequence_dir> <out.npz|out.txt>
      [--stride N] [--n-words W | --tree k L] [--features F] [--max-frames M]
      [--device DEV]

  mode: tum-rgbd | tum-mono | kitti-mono | kitti-stereo | euroc-mono | euroc-stereo
  A .txt output path selects the reference's DBoW2 text format (tree only).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode")
    ap.add_argument("sequence_dir")
    ap.add_argument("out")
    ap.add_argument("--stride", type=int, default=10,
                    help="train on every Nth frame")
    ap.add_argument("--n-words", type=int, default=4096,
                    help="flat vocabulary size")
    ap.add_argument("--tree", nargs=2, type=int, metavar=("K", "L"),
                    help="train a k-ary depth-L tree instead (DBoW2 shape: 10 6)")
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--max-frames", type=int, default=200)
    add_device_argument(ap)
    return ap.parse_args(argv)


def extract_descriptors(ds, stride: int, max_frames: int, n_features: int, device) -> list:
    """The valid ORB descriptors, (n, 8) uint32, of every `stride`-th image
    (at most `max_frames`), one array per image."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy
    from orb_slam2_detailed_comments_tpu_torch.ops.orb import extract_orb
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig

    cap = 1 << int(np.ceil(np.log2(max(n_features, 2))))
    orb = OrbConfig(n_features=n_features, max_keypoints=cap)
    descs = []
    for n, i in enumerate(range(0, len(ds), stride)):
        if n >= max_frames:
            break
        img = torch.as_tensor(np.asarray(ds[i][1], np.float32)).to(device)
        kp = extract_orb(img, orb)
        descs.append(desc_to_numpy(kp.desc)[kp.valid.cpu().numpy()])
        if n % 20 == 0:
            print(f"frame {i}: {sum(len(d) for d in descs)} descriptors", flush=True)
    return descs


def run(argv=None):
    """main's work: returns the vocabulary as trained (before the save) and
    the per-image descriptors it was trained on."""
    args = parse_args(argv)
    device = check_device(args.device)
    from orb_slam2_detailed_comments_tpu_torch.io.datasets import (
        EurocDataset, KittiOdometryDataset, TumRgbdDataset)

    if args.mode.startswith("tum"):
        ds = TumRgbdDataset(args.sequence_dir)
    elif args.mode.startswith("kitti"):
        ds = KittiOdometryDataset(args.sequence_dir, stereo=False)
    elif args.mode.startswith("euroc"):
        ds = EurocDataset(args.sequence_dir, stereo=False)
    else:
        raise SystemExit(f"unknown mode {args.mode}")

    descs = extract_descriptors(ds, args.stride, args.max_frames, args.features, device)
    train = np.concatenate(descs, axis=0)
    print(f"training on {len(train)} descriptors from {len(descs)} frames")

    if args.tree or args.out.endswith(".txt"):
        from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary
        k, L = args.tree if args.tree else (10, 4)
        voc = TreeVocabulary.train(train, k=k, L=L)
        if args.out.endswith(".txt"):
            voc.save_dbow2_text(args.out)
        else:
            voc.save(args.out)
        print(f"tree vocabulary (k={k}, L={L}, {voc.n_words} words) -> {args.out}")
    else:
        from orb_slam2_detailed_comments_tpu_torch.place.vocabulary import BinaryVocabulary
        voc = BinaryVocabulary.train(train, n_words=args.n_words, device=device)
        voc.save(args.out)
        print(f"flat vocabulary ({voc.n_words} words) -> {args.out}")
    return voc, descs


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
