"""Content-addressed stage artifacts for mid-pipeline resume.

The reference's only resume mechanism is ``--use_old_sorted_file``, which
blindly trusts whatever ``sorted.fastq`` sits in the outfolder (reference
get_sorted_fastq_for_cluster.py:162-164).  With ``--resume`` each expensive
stage is keyed by the sha256 of its *input content* plus every parameter
that affects its output; a stage re-runs exactly when its inputs or
parameters changed (SURVEY.md section 5, checkpoint/resume).

Artifacts live in ``<outfolder>/.ngsid_cache/``:
  * ``manifest.json`` — stage name -> {key, files}
  * stage payloads (e.g. ``clusters.json`` — the exact engine-ordered
    cluster membership, so a resumed consensus stage sees byte-identical
    input to a fresh run)
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

CACHE_DIR = ".ngsid_cache"
_DIGEST_CHUNK = 1 << 22


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_DIGEST_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def params_key(params: Dict) -> str:
    return hashlib.sha256(
        json.dumps(params, sort_keys=True).encode()
    ).hexdigest()


def stage_key(input_digest: str, params: Dict) -> str:
    return hashlib.sha256(
        (input_digest + ":" + params_key(params)).encode()
    ).hexdigest()


class ArtifactCache:
    """Manifest-backed stage cache under the run's outfolder."""

    def __init__(self, outfolder: str) -> None:
        self.dir = os.path.abspath(os.path.join(outfolder, CACHE_DIR))
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        self._manifest: Dict[str, Dict] = {}
        if os.path.isfile(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    self._manifest = json.load(f)
            except (OSError, ValueError):
                self._manifest = {}

    def lookup(self, stage: str, key: str) -> Optional[List[str]]:
        """Absolute artifact paths when `stage` is cached under `key` and
        every file still exists; else None."""
        entry = self._manifest.get(stage)
        if not entry or entry.get("key") != key:
            return None
        files = [os.path.join(self.dir, f) if not os.path.isabs(f) else f
                 for f in entry.get("files", [])]
        if all(os.path.isfile(f) for f in files):
            return files
        return None

    def record(self, stage: str, key: str, files: List[str]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        files = [os.path.abspath(f) for f in files]
        rel = [os.path.relpath(f, self.dir) if f.startswith(self.dir + os.sep)
               else f for f in files]
        self._manifest[stage] = {"key": key, "files": rel}
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1)
        os.replace(tmp, self.manifest_path)

    def path(self, name: str) -> str:
        os.makedirs(self.dir, exist_ok=True)
        return os.path.join(self.dir, name)


# ---------------------------------------------------------------------------
# stage payload codecs
# ---------------------------------------------------------------------------

def save_clusters(path: str, clusters: Dict[int, List[str]]) -> None:
    """Engine-ordered cluster membership: {rep read id: member accessions
    (with score suffix) in join order} — exactly what the consensus stage
    consumes, so fresh and resumed runs are byte-identical downstream."""
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in clusters.items()}, f)


def load_clusters(path: str) -> Dict[int, List[str]]:
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}
