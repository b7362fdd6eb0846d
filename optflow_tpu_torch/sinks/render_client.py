"""Render web-service read-side HTTP client.

The reference's job generator pulls tilespecs live from Render via
renderapi (support_scripts/gen_cross_file_list.py:18-21: connect +
get_tile_specs_from_stack -> {tileId: imageUrl}) and its offline uploader
both reads tile geometry (upload_matches.py:12-16: maxX/maxY per tile)
and checks match-group existence for idempotent re-runs
(upload_matches.py:26-27). This module is the stdlib-urllib equivalent —
the same REST endpoints renderapi wraps — so gen_pairs / upload_matches
can run against a live render-ws with no local JSON files, completing the
P1/P2 drop-in story.

Endpoints used (render-ws v1 REST API):
  GET {base}/owner/{o}/project/{p}/stack/{s}/zValues
  GET {base}/owner/{o}/project/{p}/stack/{s}/z/{z}/tile-specs
  GET {base}/owner/{o}/matchCollection/{mc}/group/{g}/matchesWith/{g2}

Write-side PUT lives in sinks/http.py (RenderHttpSink); this client is
read-only by design.
"""

from __future__ import annotations

import json
import sys
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple


class RenderClient:
    def __init__(
        self,
        host: str,
        port: str = "8080",
        owner: str = "flyem",
        project: str = "default",
        *,
        timeout: float = 10.0,
    ):
        self.base = f"http://{host}:{port}/render-ws/v1"
        self.owner = owner
        self.project = project
        self.timeout = timeout

    # -- plumbing ---------------------------------------------------------

    def _get(self, path: str):
        url = self.base + path
        req = urllib.request.Request(
            url, headers={"Accept": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _stack(self, stack: str) -> str:
        return (
            f"/owner/{urllib.parse.quote(self.owner)}"
            f"/project/{urllib.parse.quote(self.project)}"
            f"/stack/{urllib.parse.quote(stack)}"
        )

    # -- tilespecs --------------------------------------------------------

    def z_values(self, stack: str) -> List[float]:
        return list(self._get(self._stack(stack) + "/zValues"))

    def tile_specs(self, stack: str) -> List[dict]:
        """All tilespec dicts of the stack (one GET per z layer, the same
        access pattern as renderapi.tilespec.get_tile_specs_from_stack)."""
        specs: List[dict] = []
        for z in self.z_values(stack):
            zs = ("%g" % z) if z == int(z) else repr(z)
            specs.extend(
                self._get(self._stack(stack) + f"/z/{zs}/tile-specs")
            )
        return specs

    @staticmethod
    def _image_url(spec: dict) -> Optional[str]:
        """First mipmap level's imageUrl, stripped of its scheme prefix
        (the reference keeps only the path: imageUrl.split(':')[-1],
        gen_cross_file_list.py:21)."""
        mipmaps = spec.get("mipmapLevels") or {}
        for key in sorted(mipmaps):
            url = mipmaps[key].get("imageUrl")
            if url:
                return url.split(":")[-1]
        return None

    def image_urls(self, stack: str) -> Dict[str, str]:
        """{tileId: image path} — the projection gen_pairs consumes."""
        out: Dict[str, str] = {}
        for spec in self.tile_specs(stack):
            url = self._image_url(spec)
            if url is not None:
                out[str(spec["tileId"])] = url
        return out

    def tile_sizes(self, stack: str) -> Dict[str, dict]:
        """{tileId: {maxX, maxY}} — the geometry upload_matches consumes
        (reference upload_matches.py:15-16)."""
        return {
            str(spec["tileId"]): {
                "maxX": spec.get("maxX", 0),
                "maxY": spec.get("maxY", 0),
            }
            for spec in self.tile_specs(stack)
        }

    # -- match collections ------------------------------------------------

    def matches_exist(
        self, match_collection: str, p_group: str, q_group: str
    ) -> bool:
        """Whether the collection already holds matches between the two
        groups (reference upload_matches.py:26-27 — the idempotence
        check). A connection/HTTP failure reports False with a warning so
        a flaky read never drops work (re-uploads are harmless; render-ws
        replaces per-pair matches)."""
        path = (
            f"/owner/{urllib.parse.quote(self.owner)}"
            f"/matchCollection/{urllib.parse.quote(match_collection)}"
            f"/group/{urllib.parse.quote(str(p_group))}"
            f"/matchesWith/{urllib.parse.quote(str(q_group))}"
        )
        try:
            return len(self._get(path)) > 0
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(
                f"match-existence check failed ({e}); assuming absent",
                file=sys.stderr,
            )
            return False

    def existing_groups(
        self, match_collection: str, group_pairs
    ) -> set:
        """Subset of (pGroup, qGroup) pairs already present."""
        return {
            (str(a), str(b))
            for a, b in group_pairs
            if self.matches_exist(match_collection, a, b)
        }
