"""VMAF scoring hook around an external scorer.

A copy of ``zero_tig_tpu/eval/vmaf.py`` (:17-58). The reference ships an
empty vmaf/ directory; where a ``vmaf`` binary or an ``ffmpeg`` built with
libvmaf is on PATH, ``score_sequences`` scores an output frame directory
against a ground-truth one, and returns None otherwise.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile


def vmaf_available() -> bool:
    return shutil.which("vmaf") is not None or _ffmpeg_has_libvmaf()


def _ffmpeg_has_libvmaf() -> bool:
    ff = shutil.which("ffmpeg")
    if not ff:
        return False
    try:
        out = subprocess.run(
            [ff, "-hide_banner", "-filters"], capture_output=True, text=True,
            timeout=30,
        )
        return "libvmaf" in out.stdout
    except Exception:
        return False


def score_sequences(
    out_dir: str, gt_dir: str, *, fps: int = 30, pattern: str = "%05d.png"
) -> float | None:
    """Mean VMAF of the frame sequence in out_dir vs gt_dir, or None if no
    scorer is installed."""
    ff = shutil.which("ffmpeg")
    if not (ff and _ffmpeg_has_libvmaf()):
        return None
    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "vmaf.json")
        cmd = [
            ff, "-hide_banner",
            "-framerate", str(fps), "-i", os.path.join(out_dir, pattern),
            "-framerate", str(fps), "-i", os.path.join(gt_dir, pattern),
            "-lavfi", f"libvmaf=log_fmt=json:log_path={log}",
            "-f", "null", "-",
        ]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0 or not os.path.exists(log):
            return None
        with open(log) as f:
            data = json.load(f)
        return float(data["pooled_metrics"]["vmaf"]["mean"])
