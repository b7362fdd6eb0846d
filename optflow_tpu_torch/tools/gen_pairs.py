"""Cross-file pair-list generator — the job sharder.

Reimplements support_scripts/gen_cross_file_list.py without the renderapi
dependency: tile-id -> image-path mapping comes from a local JSON tilespec
file (or any dict), the tile-pair graph from the standard gzipped
``neighborPairs`` JSON, and output is ``base_path_<n>.json.gz`` job files
of ``ppf`` pairs each (default 5000, the reference's production
granularity).

Also implements the log-file feature heuristic
(gen_cross_file_list.py:33-41,55-60): per-image ``.log`` files whose first
token is a column count N; pairs whose image sits within 30 columns of the
boundary get per-pair ``features`` enabled. The reference compares p's URL
for both sides and tests string literals (latent bugs noted in SURVEY.md
§2.2); here both sides are evaluated correctly.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
from typing import Dict, Optional


def defaults(n: int, **kwargs) -> dict:
    """Job-level config defaults (ref: gen_cross_file_list.py:75-99)."""
    d = {}
    d["style"] = kwargs.get("style", 1)
    d["debug"] = kwargs.get("debug", False)
    if kwargs.get("features") is not None:
        d["features"] = kwargs.get("features", 2)
    d["homo"] = kwargs.get("homo", 4)
    d["ratio"] = kwargs.get("ratio", 0.7)
    d["ransac"] = kwargs.get("ransac", 5)
    d["hessianThreshold"] = kwargs.get("hessianThreshold", 1600)
    d["scale"] = kwargs.get("scale", 0.5)
    d["output_dir"] = kwargs.get("output_dir", ".")
    if kwargs.get("top"):
        d.setdefault("rois", {})["top"] = kwargs["top"]
    if kwargs.get("bottom"):
        d.setdefault("rois", {})["bottom"] = kwargs["bottom"]
    d["output_type"] = kwargs.get("output_type", "random_points")
    d["npoints"] = kwargs.get("npoints", n)
    return d


def logpath(log_dir: str, imageurl: str) -> str:
    """Derive the per-image log path by stripping the trailing -suffix
    (e.g. -InLens) from the image name (ref: gen_cross_file_list.py:67-72)."""
    image_name = imageurl.split("/")[-1]
    image_name = "-".join(image_name.split("-")[:-1])
    return os.path.join(log_dir, image_name + ".log")


def _column_of(imageurl: str) -> int:
    """Column index parsed from the filename convention ...-c-r-s-InLens."""
    return int(imageurl.split("-")[-2])


def gen_file_list(
    cross: str,
    imageurls: Dict[str, str],
    base_path: str,
    n: int = 10,
    match: str = "forgetful_owner",
    ppf: int = 5000,
    logdir: Optional[str] = None,
    connect: Optional[dict] = None,
    sub_list=None,
    **kwargs,
) -> int:
    """Write sharded job files; returns the number of files written.

    Args:
      cross: path to the gzipped tile-pair graph (``neighborPairs`` JSON).
      imageurls: tileId -> image path map (the tilespec projection the
        reference pulls from Render, gen_cross_file_list.py:19-21).
      connect: optional {host, port, owner} for the HTTP sink fields.
    """
    optflow = defaults(n, **kwargs)
    optflow["matchCollection"] = match
    if connect:
        for k in ("host", "port", "owner"):
            if connect.get(k) is not None:
                optflow[k] = connect[k]

    opener = gzip.open if cross.endswith(".gz") else open
    with opener(cross, "rt") as f:
        pairs = json.load(f)

    neighbor_pairs = pairs["neighborPairs"]
    chunks = [
        neighbor_pairs[i : i + ppf]
        for i in range(0, len(neighbor_pairs), ppf)
    ]

    n_dict: Dict[str, float] = {}

    def log_n(url: str) -> float:
        if url not in n_dict:
            with open(logpath(logdir, url)) as f:
                n_dict[url] = float(next(f).split(" ")[0])
        return n_dict[url]

    count = 0
    for count, sub_pairs in enumerate(chunks):
        images = []
        for pair in sub_pairs:
            p_url = imageurls[pair["p"]["id"]]
            q_url = imageurls[pair["q"]["id"]]
            if sub_list is not None:
                ga = int(float(pair["p"]["groupId"]))
                gb = int(float(pair["q"]["groupId"]))
                if ga not in sub_list and gb not in sub_list:
                    continue
            im_data = {
                "p": p_url,
                "q": q_url,
                "pId": pair["p"]["id"],
                "qId": pair["q"]["id"],
                "pGroupId": pair["p"]["groupId"],
                "qGroupId": pair["q"]["groupId"],
                "output_name": pair["p"]["id"] + "_" + pair["q"]["id"],
            }
            if logdir is not None:
                col_p = _column_of(p_url)
                col_q = _column_of(q_url)
                near_edge = (log_n(p_url) - col_p < 30) or (
                    log_n(q_url) - col_q < 30
                )
                if near_edge:
                    im_data["features"] = kwargs.get("features", 2) or 2
            images.append(im_data)
        optflow["images"] = images
        with gzip.open(f"{base_path}_{count}.json.gz", "wt") as fout:
            json.dump(optflow, fout)
    return len(chunks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate sharded optflow job files from a tile-pair graph"
    )
    parser.add_argument("cross", help="gzipped neighborPairs JSON")
    parser.add_argument(
        "--tile-images",
        default=None,
        help="JSON file mapping tileId -> image path (offline mode)",
    )
    parser.add_argument(
        "--stack",
        default=None,
        help="Render stack name: pull the tileId -> image map live from "
        "render-ws (requires --host; the reference's renderapi path, "
        "gen_cross_file_list.py:18-21)",
    )
    parser.add_argument(
        "--project", default=os.environ.get("RENDER_PROJECT", "default")
    )
    parser.add_argument("--base_path", default="/tmp/optflow")
    parser.add_argument("--n", default=10, type=int, help="points per pair")
    parser.add_argument("--match", default="forgetful_owner")
    parser.add_argument("--ppf", default=5000, type=int)
    parser.add_argument("--top", default=0, type=int)
    parser.add_argument("--bottom", default=0, type=int)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--features", default=None, type=int)
    parser.add_argument("--host", default=os.environ.get("RENDER_HOST"))
    parser.add_argument("--port", default=os.environ.get("RENDER_PORT"))
    parser.add_argument("--owner", default=os.environ.get("RENDER_OWNER"))
    ns = parser.parse_args(argv)

    if ns.tile_images:
        with open(ns.tile_images) as f:
            imageurls = json.load(f)
    elif ns.stack and ns.host:
        from optflow_tpu_torch.sinks.render_client import RenderClient

        client = RenderClient(
            ns.host, ns.port or "8080", ns.owner or "flyem", ns.project
        )
        imageurls = client.image_urls(ns.stack)
    else:
        parser.error("provide --tile-images, or --stack with --host")

    n_files = gen_file_list(
        ns.cross,
        imageurls,
        ns.base_path,
        n=ns.n,
        match=ns.match,
        ppf=ns.ppf,
        logdir=ns.logdir,
        connect={"host": ns.host, "port": ns.port, "owner": ns.owner},
        top=ns.top,
        bottom=ns.bottom,
        features=ns.features,
    )
    print(f"wrote {n_files} job files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
