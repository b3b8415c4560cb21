"""Raw dataset manifest and archive unpacking (the JAX package's
``data/download.py``).

The manifest lists the MVUB / 8iVFBv2 / UVG-VPC archives, either as
``{name: {"url": ..., "sequences": [...]}}`` (``DEFAULT_MANIFEST``) or as
``{dataset: {sequence: url}}`` (``data/config/download_paths.yaml``).
Nothing is fetched: for each archive this reports what would be fetched
and where, and unpacks an archive that is already at that place (copied
there by hand).  The manifest is JSON or YAML (YAML needs the yaml
package).

    python3 -m upcc_tpu_torch.data.download --manifest \\
        data/config/download_paths.yaml --dest ./data/raw
"""

import argparse
import os
import tarfile
import zipfile

from .dataset import read_config

DEFAULT_MANIFEST = {
    "8iVFBv2": {
        "url": "https://plenodb.jpeg.org/pc/8ilabs/loot.zip",
        "sequences": ["loot", "longdress", "soldier", "redandblack"],
    },
    "MVUB": {
        "url": "https://plenodb.jpeg.org/pc/microsoft/",
        "sequences": ["andrew9", "david9", "phil9", "ricardo9", "sarah9"],
    },
    "Owlii": {
        "url": "(mpeg content repository)",
        "sequences": ["basketball_player", "dancer", "exercise", "model"],
    },
}


def _extract(path, dest):
    """Unpack a .zip, .tar, .tar.gz or .tgz archive into ``dest``; other
    files are left as they are.  Returns whether it unpacked."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
        return True
    if path.endswith((".tar", ".tar.gz", ".tgz")):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
        return True
    return False


def archives(manifest, dest):
    """[(dataset, url, local archive path, sequences)] of a manifest."""
    out = []
    for name, spec in manifest.items():
        folder = os.path.join(dest, name)
        if "url" in spec:
            url = spec["url"]
            out.append((name, url, os.path.join(
                folder, os.path.basename(url) or "archive.zip"),
                spec.get("sequences")))
        else:
            out += [(name, url, os.path.join(folder, os.path.basename(url)),
                     [seq]) for seq, url in spec.items()]
    return out


def download_datasets(manifest_path=None, dest="./data/raw"):
    """Report each archive that would be fetched and unpack those already
    in place; returns the list of archives unpacked."""
    manifest = DEFAULT_MANIFEST
    if manifest_path and os.path.exists(manifest_path):
        manifest = read_config(manifest_path)
    os.makedirs(dest, exist_ok=True)
    unpacked = []
    for name, url, path, seqs in archives(manifest, dest):
        if os.path.isfile(path):
            if _extract(path, os.path.dirname(path)):
                print(f"[{name}] unpacked {path}")
                unpacked.append(path)
            continue
        print(f"[{name}] no network access here — would fetch {url} -> "
              f"{path} (sequences: {seqs})")
    return unpacked


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", default="data/config/download_paths.yaml")
    ap.add_argument("--dest", default="./data/raw")
    a = ap.parse_args()
    download_datasets(a.manifest, a.dest)
