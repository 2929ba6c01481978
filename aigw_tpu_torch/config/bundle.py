"""Sharded, checksummed config bundles (the port's copy of
``aigw_tpu/config/bundle.py``).

Upstream splits the marshalled config into parts of at most 1 MB with an
``index.yaml`` carrying SHA-256 checksums, so a half-written update is
never loaded (internal/controller/filter_config_bundle.go:31-125,
internal/filterapi/config_bundle.go:19-66). The same scheme on a
directory: ``index.json`` + ``part-N.json``, byte for byte the
reference's, so a bundle written by either package reads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid as uuidlib
from typing import Any

from aigw_tpu_torch.config.model import Config, ConfigError

DEFAULT_PART_SIZE = 1 << 20  # 1 MiB, the reference's Secret-size bound


def write_bundle(cfg: Config, directory: str, part_size: int = DEFAULT_PART_SIZE) -> str:
    """Write cfg as a sharded bundle; returns the bundle UUID.

    Parts are written before the index so a concurrent reader either sees a
    complete consistent bundle or fails the checksum gate and keeps its
    current config (the reference's atomicity strategy,
    filter_config_bundle.go:46).
    """
    os.makedirs(directory, exist_ok=True)
    bundle_uuid = cfg.uuid or str(uuidlib.uuid4())
    data = dict(cfg.to_dict())
    data["uuid"] = bundle_uuid
    blob = json.dumps(data, sort_keys=True).encode()
    parts = [blob[i : i + part_size] for i in range(0, len(blob), part_size)] or [b""]
    index: dict[str, Any] = {
        "uuid": bundle_uuid,
        "version": cfg.version,
        "parts": [],
    }
    for i, part in enumerate(parts):
        name = f"part-{i}.json"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(part)
        index["parts"].append(
            {"name": name, "sha256": hashlib.sha256(part).hexdigest()}
        )
    tmp = os.path.join(directory, ".index.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(index, f)
    os.replace(tmp, os.path.join(directory, "index.json"))
    return bundle_uuid


def read_bundle(directory: str) -> Config:
    """Read and checksum-verify a bundle directory → Config."""
    index_path = os.path.join(directory, "index.json")
    with open(index_path, "r", encoding="utf-8") as f:
        index = json.load(f)
    blob = b""
    for part in index["parts"]:
        with open(os.path.join(directory, part["name"]), "rb") as f:
            data = f.read()
        digest = hashlib.sha256(data).hexdigest()
        if digest != part["sha256"]:
            raise ConfigError(
                f"bundle part {part['name']} checksum mismatch "
                f"(expected {part['sha256'][:12]}…, got {digest[:12]}…)"
            )
        blob += data
    cfg = Config.parse(json.loads(blob.decode()))
    return cfg
