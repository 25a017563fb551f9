"""File-based render report — the GUI/ImGui replacement.

The reference's interactive surface is ImGui panels + a GLFW preview window
(/root/reference/src/libraries/KIRK/Utils/Gui/*, Demo/main.cpp:325): live
sample counts, material/BSDF switchers, tonemapper luminances, accel-
structure stats. Accelerator hosts have no display (SURVEY §7 step 8 scopes the GUI
out and calls for a file-based viewer), so the same observability is a
self-contained HTML report: renders inlined as base64 PNGs next to the
run's metadata, per-phase timings, accel-structure debug info, and the
tonemapper parameters.
"""

from __future__ import annotations

import base64
import html
import json
import os
import time
from typing import Any

import numpy as np

def _png_bytes(img: np.ndarray, gamma: float = 2.2) -> bytes:
    from .film import encode_png

    return encode_png(img, gamma=gamma)


class RenderReport:
    """Collects images + key/value panels, then writes one HTML file."""

    def __init__(self, title: str = "ba_pathtracing_fur render"):
        self.title = title
        self._images: list[tuple[str, np.ndarray, float]] = []
        self._panels: list[tuple[str, dict[str, Any]]] = []
        self._created = time.strftime("%Y-%m-%d %H:%M:%S")

    def add_image(self, name: str, img, gamma: float = 2.2) -> None:
        self._images.append((name, np.asarray(img), gamma))

    def add_panel(self, name: str, values: dict[str, Any]) -> None:
        """A key/value block — the ImGui-panel analog (e.g. PathTracer
        sample count / buffer sizes, CPU_PathTracer.cpp:262-299)."""
        self._panels.append((name, dict(values)))

    def write(self, path: str) -> str:
        parts = [
            "<!doctype html><html><head><meta charset='utf-8'>",
            f"<title>{html.escape(self.title)}</title>",
            "<style>body{font:14px sans-serif;background:#161616;color:#ddd;"
            "margin:2em}h1{font-size:20px}h2{font-size:16px;margin-top:1.5em}"
            "img{image-rendering:pixelated;border:1px solid #444;max-width:512px}"
            "table{border-collapse:collapse}td{padding:2px 10px;border:1px solid #333}"
            "figure{display:inline-block;margin:0 1em 1em 0}</style></head><body>",
            f"<h1>{html.escape(self.title)}</h1>",
            f"<p>created {self._created}</p>",
        ]
        for name, img, gamma in self._images:
            data = base64.b64encode(_png_bytes(img, gamma)).decode()
            parts.append(
                f"<figure><img src='data:image/png;base64,{data}' "
                f"alt='{html.escape(name)}'>"
                f"<figcaption>{html.escape(name)} "
                f"({img.shape[1]}×{img.shape[0]})</figcaption></figure>")
        for name, values in self._panels:
            parts.append(f"<h2>{html.escape(name)}</h2><table>")
            for k, v in values.items():
                if isinstance(v, float):
                    v = f"{v:.6g}"
                parts.append(f"<tr><td>{html.escape(str(k))}</td>"
                             f"<td>{html.escape(str(v))}</td></tr>")
            parts.append("</table>")
        parts.append("</body></html>")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("".join(parts))
        return path

    def write_json_sidecar(self, path: str) -> str:
        """Machine-readable twin of the panels (jsonout.cpp-style mirror).
        Panels are a list of [name, values] pairs — duplicate panel names
        render separately in the HTML and must survive here too (ADVICE r1)."""
        payload = {"title": self.title, "created": self._created,
                   "panels": [[n, v] for n, v in self._panels],
                   "images": [n for n, _, _ in self._images]}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return path
