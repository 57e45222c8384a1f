"""Subtitle preprocessing: .srt -> structured jsonl.
(The port's own copy of the JAX package's features/subtitles.py.)

Capability parity with reference utils/text_feature/preprocess_subtitles.py
(:28-57): parse srt cues into {"vid_name", "sub": [{"text", "start", "end"}]}
rows, one per video, with cue text cleaned of tags/newlines. Implemented
with a small built-in srt parser (no pysrt dependency).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List

from tvretrieval_tpu_torch.utils.io import save_jsonl

_TS = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
_TAGS = re.compile(r"<[^>]+>|\{[^}]+\}")


def _seconds(h: str, m: str, s: str, ms: str) -> float:
    return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000.0


def parse_srt(text: str) -> List[Dict]:
    """Parse srt content into [{"text", "start", "end"}] cues."""
    cues = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [ln.strip() for ln in block.splitlines() if ln.strip()]
        if not lines:
            continue
        ts_line_idx = next((i for i, ln in enumerate(lines) if _TS.search(ln)), None)
        if ts_line_idx is None:
            continue
        m = _TS.search(lines[ts_line_idx])
        start = _seconds(*m.groups()[:4])
        end = _seconds(*m.groups()[4:])
        body = " ".join(lines[ts_line_idx + 1:])
        body = _TAGS.sub("", body).replace("‎", " ").strip()
        if body:
            cues.append({"text": body, "start": start, "end": end})
    return cues


def subtitles_to_jsonl(srt_dir: str, out_path: str) -> int:
    """Convert a directory of <vid_name>.srt files into one jsonl."""
    rows = []
    for fname in sorted(os.listdir(srt_dir)):
        if not fname.endswith(".srt"):
            continue
        vid_name = fname[:-4]
        with open(os.path.join(srt_dir, fname), "r", errors="ignore") as f:
            cues = parse_srt(f.read())
        rows.append({"vid_name": vid_name, "sub": cues})
    save_jsonl(rows, out_path)
    return len(rows)
