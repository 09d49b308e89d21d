"""ViT-vs-FFA loss-landscape comparison (counterpart of
`dehaze_tpu/cli/landscape_pair.py`; ≙ README.md:165-209): the two sweep
CSVs that `cli.landscape` writes (either package's) as one figure, and
one JSON line of each model's flatness statistics
(`ops.landscape.landscape_stats`) plus which is flatter.

    python -m dehaze_tpu_torch.cli.landscape_pair vit.csv ffa.csv \\
        --labels ViT FFA --out compare.jpg

--out '' prints the statistics without the figure (which needs
matplotlib).
"""

import argparse
import json

from dehaze_tpu_torch.ops import landscape as LS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="landscape comparison figure")
    p.add_argument("csv_a", help="first sweep CSV (e.g. the ViT model's)")
    p.add_argument("csv_b", help="second sweep CSV (e.g. FFA-Net's)")
    p.add_argument("--labels", nargs=2, default=("ViT", "FFA"))
    p.add_argument("--out", default="landscape_compare.jpg",
                   help="the figure ('' for none; needs matplotlib)")
    p.add_argument("--title", default="loss landscape comparison")
    args = p.parse_args(argv)

    rows_a = LS.load_landscape_csv(args.csv_a)
    rows_b = LS.load_landscape_csv(args.csv_b)
    stats = {
        args.labels[0]: LS.landscape_stats(rows_a),
        args.labels[1]: LS.landscape_stats(rows_b),
    }
    a, b = (stats[lb]["mean_rel_rise"] for lb in args.labels)
    stats["flatter"] = args.labels[0] if a < b else args.labels[1]
    if args.out:
        try:
            LS.plot_landscape_pair(rows_a, rows_b, args.out,
                                   labels=args.labels, title=args.title)
        except ImportError as e:
            raise SystemExit(str(e)) from e
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    main()
