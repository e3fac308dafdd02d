"""Sharded-tar dataset tooling: build, extract, inspect.

The twin of tools/wds_tools.py (the port imports nothing of the JAX
package): `convert` packs the files of each sample (color.png, depth.exr,
meta.json, heatmap.npz, pose_map.npz, ...) into tar shards, and with
--gen-targets generates the heatmap / pose-map targets from instance masks
and poses (a targets.json sidecar) through this package's preprocessing;
`extract` unpacks shards; `list` shows what they hold.

  python -m hunyuanworld_mirror_tpu_torch.wds_tools convert <sample_dir> <out_dir> [--shard-size N]
  python -m hunyuanworld_mirror_tpu_torch.wds_tools extract <shard.tar ...> <out_dir>
  python -m hunyuanworld_mirror_tpu_torch.wds_tools list <shard.tar ...>

`convert` expects per-sample file groups named <key>.<ext> in sample_dir
(e.g. 000001.color.png, 000001.depth.exr, 000001.meta.json, ...); every file
sharing a key lands in one sample.
"""

import argparse
import io
import json
import os
import tarfile
from collections import defaultdict
from pathlib import Path

import numpy as np


def group_samples(sample_dir: str):
    """Group <key>.<suffix> files by key; suffix = everything after the first
    dot (webdataset convention)."""
    groups = defaultdict(dict)
    for f in sorted(Path(sample_dir).iterdir()):
        if not f.is_file():
            continue
        name = f.name
        if "." not in name:
            continue
        key, suffix = name.split(".", 1)
        groups[key][suffix] = f
    return dict(sorted(groups.items()))


def do_convert(sample_dir: str, out_dir: str, shard_size: int = 1000,
               prefix: str = "shard", gen_targets: bool = False):
    """Pack sample groups into `<prefix>-%06d.tar` shards of `shard_size`."""
    os.makedirs(out_dir, exist_ok=True)
    groups = group_samples(sample_dir)
    keys = list(groups)
    n_shards = 0
    written = 0
    tar = None
    for i, key in enumerate(keys):
        if i % shard_size == 0:
            if tar is not None:
                tar.close()
            path = os.path.join(out_dir, f"{prefix}-{n_shards:06d}.tar")
            tar = tarfile.open(path, "w")
            n_shards += 1
        members = dict(groups[key])
        if gen_targets and "heatmap.npz" not in members and "targets.json" in members:
            _add_generated_targets(tar, key, members)
        for suffix, f in members.items():
            data = f.read_bytes()
            _add_bytes(tar, f"{key}.{suffix}", data)
        written += 1
    if tar is not None:
        tar.close()
    print(f"wrote {written} samples into {n_shards} shards under {out_dir}")
    return n_shards


def _add_bytes(tar, name: str, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _add_generated_targets(tar, key: str, members: dict):
    """Generate heatmap/pose_map targets from a targets.json sidecar:
    {"masks": "<path to .npz with (n,H,W) bool>", "rotations": [[...3x3]],
     "translations": [[x,y,z]], "sizes": [[sx,sy,sz]], "intrinsics": [[3x3]]}
    """
    from . import preprocessing as prep

    spec = json.loads(members.pop("targets.json").read_text())
    masks = np.load(spec["masks"])["masks"] if isinstance(spec["masks"], str) \
        else np.asarray(spec["masks"], bool)
    heat, field = prep.make_targets(
        [m for m in masks],
        [np.asarray(r, np.float32) for r in spec["rotations"]],
        [np.asarray(t, np.float32) for t in spec["translations"]],
        [np.asarray(s, np.float32) for s in spec["sizes"]],
        np.asarray(spec["intrinsics"], np.float32) if "intrinsics" in spec else None)
    _add_bytes(tar, f"{key}.heatmap.npz", _npz_bytes(heatmap=heat))
    _add_bytes(tar, f"{key}.pose_map.npz", _npz_bytes(abs_pose=field))


def do_extract(shards, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for shard in shards:
        with tarfile.open(shard) as tar:
            for m in tar.getmembers():
                if not m.isfile():
                    continue
                data = tar.extractfile(m).read()
                with open(os.path.join(out_dir, os.path.basename(m.name)), "wb") as f:
                    f.write(data)
                n += 1
    print(f"extracted {n} files to {out_dir}")


def do_list(shards):
    for shard in shards:
        with tarfile.open(shard) as tar:
            members = [m for m in tar.getmembers() if m.isfile()]
            keys = sorted({m.name.split(".", 1)[0] for m in members})
            print(f"{shard}: {len(keys)} samples, {len(members)} files")
            for k in keys[:5]:
                suffixes = sorted(m.name.split('.', 1)[1]
                                  for m in members if m.name.startswith(k + "."))
                print(f"  {k}: {suffixes}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("sample_dir")
    c.add_argument("out_dir")
    c.add_argument("--shard-size", type=int, default=1000)
    c.add_argument("--prefix", default="shard")
    c.add_argument("--gen-targets", action="store_true",
                   help="generate heatmap/pose_map npz from targets.json sidecars")
    e = sub.add_parser("extract")
    e.add_argument("shards", nargs="+")
    e.add_argument("out_dir")
    l = sub.add_parser("list")
    l.add_argument("shards", nargs="+")
    args = p.parse_args(argv)

    if args.cmd == "convert":
        do_convert(args.sample_dir, args.out_dir, args.shard_size, args.prefix,
                   args.gen_targets)
    elif args.cmd == "extract":
        do_extract(args.shards, args.out_dir)
    else:
        do_list(args.shards)


if __name__ == "__main__":
    main()
