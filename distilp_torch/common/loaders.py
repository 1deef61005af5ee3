"""Profile JSON loaders.

Loader semantics match the reference CLI loaders
(upstream distilp src/cli/solver.py:15-86) so that fixture folders are
interchangeable between implementations:

- a profile folder holds ``model_profile.json`` plus any number of device
  JSONs (every other ``*.json``), sorted by filename;
- the first device is forced to be the head;
- a model JSON whose ``f_q`` has ``prefill``/``decode`` keys is the Split
  format and is collapsed to solver scalars from the decode phase.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

from .device import DeviceProfile
from .model import ModelProfile, ModelProfileSplit


def load_device_profile(path: str | Path) -> DeviceProfile:
    with open(path, "r") as f:
        return DeviceProfile.model_validate(json.load(f))


def parse_model_profile(data: dict) -> ModelProfile | ModelProfileSplit:
    """Validate a model-profile dict, sniffing scalar vs Split wire format.

    A ``f_q`` dict with ``prefill``/``decode`` keys marks the Split format.
    """
    f_q = data.get("f_q")
    if isinstance(f_q, dict) and "prefill" in f_q and "decode" in f_q:
        return ModelProfileSplit.model_validate(data)
    return ModelProfile.model_validate(data)


def load_model_profile(path: str | Path) -> ModelProfile:
    """Load either scalar (ModelProfile) or array (ModelProfileSplit) format."""
    with open(path, "r") as f:
        data = json.load(f)

    model = parse_model_profile(data)
    if isinstance(model, ModelProfileSplit):
        return model.to_model_profile()
    return model


def load_devices_and_model(
    device_paths: List[str | Path], model_path: str | Path
) -> Tuple[List[DeviceProfile], ModelProfile]:
    devices = []
    for i, p in enumerate(device_paths):
        device = load_device_profile(p)
        if i == 0:
            device.is_head = True
        devices.append(device)
    return devices, load_model_profile(model_path)


def load_from_profile_folder(
    folder: str | Path,
) -> Tuple[List[DeviceProfile], ModelProfile]:
    folder = Path(folder)
    if not folder.exists():
        fallback = Path("tests/profiles") / folder
        if not fallback.exists():
            raise FileNotFoundError(f"Profile folder not found: {folder}")
        folder = fallback

    model_file = folder / "model_profile.json"
    if not model_file.exists():
        raise FileNotFoundError(f"model_profile.json not found in {folder}")

    device_files = sorted(
        str(p) for p in folder.glob("*.json") if p.name != "model_profile.json"
    )
    if not device_files:
        raise ValueError(f"No device profiles found in {folder}")

    return load_devices_and_model(device_files, model_file)
