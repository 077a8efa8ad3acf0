"""The RGB-D dataset converters' command line, with the flags of the JAX
package's ``scripts/convert_dataset.py``: each sequence becomes
``<output_root>/rgbd_ply/*.ply`` plus ``poses.txt`` (``converters.py``).

Usage:
  python -m pin_slam_torch.dataset.convert_dataset replica    --input_root <seq> --output_root <out>
  python -m pin_slam_torch.dataset.convert_dataset tum        --input_root <seq> --output_root <out>
  python -m pin_slam_torch.dataset.convert_dataset neuralrgbd --input_root <seq> --output_root <out>

``--max_frames`` converts the first N frames.  ``--down_sample`` is accepted
and changes nothing, as in the JAX script: the converters write every
backprojected point (their stride is fixed per dataset).
"""

from __future__ import annotations

import argparse

from pin_slam_torch.dataset import converters as cv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset", choices=["replica", "tum", "neuralrgbd"])
    ap.add_argument("--input_root", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--down_sample", action="store_true",
                    help="accepted for the JAX script's command line; changes nothing")
    args = ap.parse_args(argv)
    fn = {"replica": cv.convert_replica, "tum": cv.convert_tum,
          "neuralrgbd": cv.convert_neuralrgbd}[args.dataset]
    fn(args.input_root, args.output_root, max_frames=args.max_frames)
    print(f"Converted {args.dataset} sequence {args.input_root} -> {args.output_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
