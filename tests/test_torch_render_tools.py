"""The port's render-ws client, job generator and match uploader against the
JAX package's, on the CPU, with render-ws mocked by a local HTTP server (no
network): both clients read one mock, both tools write the same job files
and match records from the same inputs, and the port's sink PUTs the Render
match schema to the Render path."""

import gzip
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from optflow_tpu.core.imgio import write_float_tiff
from optflow_tpu.sinks.render_client import RenderClient as JaxClient
from optflow_tpu.sinks.store import JsonlMatchSink as JaxJsonl
from optflow_tpu.tools import gen_pairs as jgp
from optflow_tpu.tools import upload_matches as jum
from optflow_tpu_torch.sinks.render_client import RenderClient
from optflow_tpu_torch.sinks.store import JsonlMatchSink
from optflow_tpu_torch.tools import gen_pairs as tgp
from optflow_tpu_torch.tools import upload_matches as tum

OWNER, PROJECT, STACK, MC = "flyem", "proj", "stack", "mc"
# z -> tile specs of the mocked stack; one z value is not an integer
SPECS = {
    1.0: [{"tileId": "t1", "maxX": 4000, "maxY": 3000,
           "mipmapLevels": {"0": {"imageUrl": "file:/data/im-1-3-0-InLens.png"}}}],
    2.0: [{"tileId": "t2", "maxX": 4100, "maxY": 3000,
           "mipmapLevels": {"1": {"imageUrl": "file:/data/x.png"},
                            "0": {"imageUrl": "file:/data/im-2-3-0-InLens.png"}}},
          {"tileId": "t2b", "maxX": 10, "mipmapLevels": {}}],
    2.5: [{"tileId": "t3", "maxX": 4000, "maxY": 2900,
           "mipmapLevels": {"0": {"imageUrl": "/data/im-3-3-0-InLens.png"}}}],
}
PRESENT = {("1.0", "2.0")}  # group pairs the collection already holds


class _RenderWs(BaseHTTPRequestHandler):
    """The render-ws v1 endpoints the tools use: stack z values and tile
    specs, whether matches exist between two groups, and the match PUT,
    whose requests it keeps."""

    puts = []

    def log_message(self, *a):
        pass

    def _reply(self, body, code=200):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        stack = f"/render-ws/v1/owner/{OWNER}/project/{PROJECT}/stack/{STACK}"
        if self.path == stack + "/zValues":
            return self._reply(sorted(SPECS))
        if self.path.startswith(stack + "/z/") and parts[-1] == "tile-specs":
            return self._reply(SPECS.get(float(parts[-2]), []))
        if "matchesWith" in parts:
            g1 = parts[parts.index("group") + 1]
            g2 = parts[parts.index("matchesWith") + 1]
            return self._reply([{"pGroupId": g1, "qGroupId": g2}]
                               if (g1, g2) in PRESENT else [])
        self._reply({"error": self.path}, 404)

    def do_PUT(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).puts.append((self.path, self.headers["Content-Type"],
                                json.loads(body)))
        self._reply({})


@pytest.fixture(scope="module")
def render_ws():
    srv = HTTPServer(("127.0.0.1", 0), _RenderWs)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield "127.0.0.1", str(srv.server_address[1])
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _clients(render_ws, **kw):
    host, port = render_ws
    return (JaxClient(host, port, owner=OWNER, project=PROJECT, **kw),
            RenderClient(host, port, owner=OWNER, project=PROJECT, **kw))


def test_both_clients_read_the_same_stack(render_ws):
    jc, tc = _clients(render_ws)
    assert tc.base == jc.base
    assert tc.z_values(STACK) == jc.z_values(STACK) == [1.0, 2.0, 2.5]
    assert tc.tile_specs(STACK) == jc.tile_specs(STACK)
    urls = tc.image_urls(STACK)
    assert urls == jc.image_urls(STACK)
    assert urls == {"t1": "/data/im-1-3-0-InLens.png",
                    "t2": "/data/im-2-3-0-InLens.png",
                    "t3": "/data/im-3-3-0-InLens.png"}
    sizes = tc.tile_sizes(STACK)
    assert sizes == jc.tile_sizes(STACK)
    assert sizes["t2"] == {"maxX": 4100, "maxY": 3000}
    assert sizes["t2b"] == {"maxX": 10, "maxY": 0}


def test_both_clients_see_the_same_matches(render_ws):
    jc, tc = _clients(render_ws)
    pairs = [("1.0", "2.0"), ("2.0", "3.0"), ("2.0", "1.0")]
    for a, b in pairs:
        assert tc.matches_exist(MC, a, b) == jc.matches_exist(MC, a, b)
    assert tc.existing_groups(MC, pairs) == jc.existing_groups(MC, pairs) \
        == {("1.0", "2.0")}


def test_unreachable_service_reports_absent_alike(capsys):
    # port 1 on the loopback: nothing listens, the connection is refused
    for cls in (JaxClient, RenderClient):
        assert not cls("127.0.0.1", "1", timeout=0.2).matches_exist(MC, "a", "b")
        assert "assuming absent" in capsys.readouterr().err


def _write_cross(path, n_sections, z_dist):
    pairs = [{"p": {"id": f"tile_{a}", "groupId": f"{a}.0"},
              "q": {"id": f"tile_{b}", "groupId": f"{b}.0"}}
             for a in range(n_sections)
             for b in range(a + 1, min(a + 1 + z_dist, n_sections))]
    with gzip.open(path, "wt") as f:
        json.dump({"neighborPairs": pairs}, f)
    return pairs


def _read_jobs(base, n):
    out = []
    for i in range(n):
        with gzip.open(f"{base}_{i}.json.gz", "rt") as f:
            out.append(json.load(f))
    return out


def test_defaults_and_logpath_equal():
    for n, kw in ((10, {}), (5, {"features": 2, "top": 200, "bottom": 200}),
                  (7, {"style": 2, "scale": 1.0, "output_type": "map"})):
        assert tgp.defaults(n, **kw) == jgp.defaults(n, **kw)
    url = "/data/Merlin-6049_18-07-09_225210_0-0-0-InLens.png"
    assert tgp.logpath("/logs", url) == jgp.logpath("/logs", url) \
        == "/logs/Merlin-6049_18-07-09_225210_0-0-0.log"


@pytest.mark.parametrize("case", ["shards", "log_heuristic", "sub_list"])
def test_gen_file_list_writes_the_same_job_files(tmp_path, case):
    """tests/test_tools.py's generator cases through both packages: the same
    number of files and the same jobs, file by file."""
    cross = str(tmp_path / "cross.json.gz")
    kw, logdir = {}, None
    if case == "log_heuristic":
        _write_cross(cross, n_sections=3, z_dist=1)
        logdir = tmp_path / "logs"
        logdir.mkdir()
        urls = {}
        for i, col in enumerate([5, 50, 50]):  # tiles 1, 2 near the boundary
            urls[f"tile_{i}"] = f"/data/im_x_{i}-{col}-InLens.png"
            (logdir / f"im_x_{i}-{col}.log").write_text("60 other stuff\n")
        kw = {"ppf": 100, "logdir": str(logdir)}
    else:
        _write_cross(cross, n_sections=8, z_dist=3)
        urls = {f"tile_{i}": f"/data/im-{i}-0-InLens.png" for i in range(8)}
        kw = {"n": 7, "ppf": 5, "top": 100, "connect": {"host": "h",
                                                        "port": None}}
        if case == "sub_list":
            kw.update(sub_list={2, 3}, ppf=100)
    n_jax = jgp.gen_file_list(cross, urls, str(tmp_path / "jax"), **kw)
    n_port = tgp.gen_file_list(cross, urls, str(tmp_path / "port"), **kw)
    assert n_port == n_jax >= 1
    jobs = _read_jobs(tmp_path / "port", n_port)
    assert jobs == _read_jobs(tmp_path / "jax", n_jax)
    if case == "log_heuristic":
        by_p = {im["pId"]: im for im in jobs[0]["images"]}
        assert by_p["tile_0"]["features"] == 2 and by_p["tile_1"]["features"] == 2
    if case == "shards":
        assert sum(len(j["images"]) for j in jobs) == 18
        assert jobs[0]["host"] == "h" and "port" not in jobs[0]


def test_gen_pairs_live_stack_alike(render_ws, tmp_path, capsys):
    """gen-pairs --stack through both packages pulls the tile map from the
    mocked service and writes the same job file."""
    host, port = render_ws
    cross = tmp_path / "cross.json.gz"
    with gzip.open(cross, "wt") as f:
        json.dump({"neighborPairs": [
            {"p": {"id": "t1", "groupId": "1.0"},
             "q": {"id": "t2", "groupId": "2.0"}},
            {"p": {"id": "t2", "groupId": "2.0"},
             "q": {"id": "t3", "groupId": "2.5"}}]}, f)
    for tag, main in (("jax", jgp.main), ("port", tgp.main)):
        assert main([str(cross), "--stack", STACK, "--project", PROJECT,
                     "--host", host, "--port", port, "--owner", OWNER,
                     "--base_path", str(tmp_path / tag)]) == 0
    assert capsys.readouterr().out.splitlines() == ["wrote 1 job files"] * 2
    job = _read_jobs(tmp_path / "port", 1)[0]
    assert job == _read_jobs(tmp_path / "jax", 1)[0]
    assert job["images"][1]["q"] == "/data/im-3-3-0-InLens.png"
    assert job["host"] == host and job["owner"] == OWNER


def _maps(folder):
    """Flow maps of both conventions: a full map (constant displacement),
    a strip pair, a map already uploaded, and a map of the gen_pairs name
    form, which carries no group ids."""
    h, w = 64, 96
    base = folder / "1.0_2.0~tileA~tileB"
    write_float_tiff(f"{base}_0.50_x.tiff", np.full((h, w), 3.0, np.float32))
    write_float_tiff(f"{base}_0.50_y.tiff", np.full((h, w), -2.0, np.float32))
    base = folder / "3.0_4.0~tileC~tileD"
    for s, val in (("top", 1.0), ("bottom", -1.0)):
        write_float_tiff(f"{base}_0.50_{s}_x.tiff",
                         np.full((24, w), val, np.float32))
        write_float_tiff(f"{base}_0.50_{s}_y.tiff",
                         np.zeros((24, w), np.float32))
    for name in ("5.0_6.0~tE~tF", "tile_0_tile_1"):
        for c in "xy":
            write_float_tiff(f"{folder / name}_1.00_{c}.tiff",
                             np.zeros((16, 16), np.float32))


def test_gen_matches_writes_the_same_records(tmp_path, capsys):
    """tests/test_tools.py's converter cases (full map, strip pair with tile
    geometry, idempotent skip) through both packages on one folder with
    the same seeded generator: the same records, value for value."""
    _maps(tmp_path)
    sizes = {"tileA": {"maxX": 200, "maxY": 300},
             "tileB": {"maxX": 180, "maxY": 290},
             "tileC": {"maxX": 200, "maxY": 300}}
    existing = {("5.0", "6.0")}
    j_sink = JaxJsonl(str(tmp_path / "out" / "jax.jsonl"))
    t_sink = JsonlMatchSink(str(tmp_path / "out" / "port.jsonl"))
    n_jax = jum.gen_matches(str(tmp_path), j_sink, n=10, tile_sizes=sizes,
                            existing_groups=existing,
                            rng=np.random.default_rng(4))
    n_port = tum.gen_matches(str(tmp_path), t_sink, n=10, tile_sizes=sizes,
                             existing_groups=existing,
                             rng=np.random.default_rng(4))
    assert n_port == n_jax == 2
    recs = t_sink.read_all()
    assert recs == j_sink.read_all()
    full = next(r for r in recs if r["pId"] == "tileA")
    d = np.asarray(full["matches"]["q"]) - np.asarray(full["matches"]["p"])
    # (3, -2) at scale 0.5, recentred by (200 - 180) // 2 and (300 - 290) // 2
    assert np.allclose(d[0], 2 * (3.0 - 10 * 0.5))
    assert np.allclose(d[1], 2 * (-2.0 - 5 * 0.5))
    assert "skipping tile_0_tile_1" in capsys.readouterr().out


def test_upload_matches_live_stack_alike(render_ws, tmp_path, monkeypatch):
    """upload-matches --stack through both packages: tile geometry from the
    mock, the group pair the collection holds skipped, the same records
    handed to the sink, value for value, once the sampling is seeded."""
    host, port = render_ws
    _maps(tmp_path)
    puts = {}
    for tag, mod in (("jax", jum), ("port", tum)):
        got = puts.setdefault(tag, [])

        class _Sink:
            def put(self, recs, got=got):
                got.extend(recs)
                return True

        real = mod.gen_matches
        monkeypatch.setattr(mod, "RenderHttpSink", lambda **kw: _Sink())
        monkeypatch.setattr(
            mod, "gen_matches",
            lambda *a, real=real, **kw: real(*a, rng=np.random.default_rng(6),
                                             **kw))
        assert mod.main([str(tmp_path), MC, "--stack", STACK, "--project",
                         PROJECT, "--host", host, "--port", port, "--owner",
                         OWNER]) == 0
    assert puts["port"] == puts["jax"]
    groups = {(r["pGroupId"], r["qGroupId"]) for r in puts["port"]}
    assert groups == {("3.0", "4.0"), ("5.0", "6.0")}


def test_render_http_sink_puts_the_render_schema(render_ws, tmp_path,
                                                  capsys):
    """The wire: upload-matches --host sends the port's RenderHttpSink PUTs
    to the mocked render-ws. Each request goes to
    /render-ws/v1/owner/{owner}/matchCollection/{mc}/matches as JSON, and
    its body is a list of Render match records (reference:
    src/optflow.cpp:595-641): pGroupId, qGroupId, pId, qId, and matches
    with p and q as [[x...], [y...]] and one weight w per point."""
    host, port = render_ws
    _maps(tmp_path)
    _RenderWs.puts.clear()
    assert tum.main([str(tmp_path), MC, "--n", "4", "--host", host, "--port",
                     port, "--owner", OWNER]) == 0
    assert "wrote 3 match records" in capsys.readouterr().out
    assert len(_RenderWs.puts) == 3
    for path, ctype, body in _RenderWs.puts:
        assert path == f"/render-ws/v1/owner/{OWNER}/matchCollection/{MC}/matches"
        assert ctype == "application/json"
        assert isinstance(body, list) and len(body) == 1
        rec = body[0]
        assert set(rec) == {"pGroupId", "qGroupId", "pId", "qId", "matches"}
        assert all(isinstance(rec[k], str)
                   for k in ("pGroupId", "qGroupId", "pId", "qId"))
        m = rec["matches"]
        assert set(m) == {"p", "q", "w"}
        n = len(m["w"])
        assert n == 8  # 2 x 4 points a map, in both modes
        for key in ("p", "q"):
            assert len(m[key]) == 2 and all(len(c) == n for c in m[key])
            assert all(isinstance(v, float) for c in m[key] for v in c)
        assert m["w"] == [1.0] * n
    sent = {(b[0]["pGroupId"], b[0]["qGroupId"], b[0]["pId"], b[0]["qId"])
            for _, _, b in _RenderWs.puts}
    assert sent == {("1.0", "2.0", "tileA", "tileB"),
                    ("3.0", "4.0", "tileC", "tileD"),
                    ("5.0", "6.0", "tE", "tF")}
