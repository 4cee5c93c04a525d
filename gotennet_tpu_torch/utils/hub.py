"""Checkpoint resolution: a local path, a URL or a published alias, and a
download cache (``gotennet_tpu/utils/hub.py``).

Aliases read ``{task}_{size}_{label}`` (QM9 sizes small, base and large;
rMD17 base only) and name a reference Lightning ``.ckpt`` on the hub.  A
download lands in ``$CHECKPOINT_PATH``, else ``~/.gotennet_tpu/checkpoints``
(the JAX package's cache, so either package finds a file the other
fetched), through ``urllib.request`` with the JAX package's checks: the
Content-Length against the bytes written, the ``.partial`` file removed on
any failure, an empty file refused, and the mirrors of
``$GOTENNET_TPU_CHECKPOINT_MIRRORS`` tried after the hub.  Local paths and
cached aliases resolve without the network.
"""

from __future__ import annotations

import os
import shutil
import urllib.request
from urllib.parse import urlparse

from gotennet_tpu_torch.utils.logging import get_logger

__all__ = ["resolve_checkpoint", "download_file", "download_with_fallback",
           "ALIAS_SIZES"]

HUB_URL = ("https://huggingface.co/sarpaykent/GotenNet/resolve/main/"
           "pretrained/{task}/{size}/gotennet_{label}.ckpt")

ALIAS_SIZES = {"QM9": ["small", "base", "large"], "rMD17": ["base"]}
_QM9_LABELS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
               "U0", "U", "H", "G", "Cv"]


def _cache_dir() -> str:
    root = os.environ.get(
        "CHECKPOINT_PATH",
        os.path.join(os.path.expanduser("~"), ".gotennet_tpu", "checkpoints"))
    os.makedirs(root, exist_ok=True)
    return root


def download_file(url: str, dest: str, timeout: int = 60) -> str:
    """Stream ``url`` to ``dest`` through ``dest + '.partial'``; the size
    is checked against the Content-Length when the server sends one, and
    the partial file is removed on any failure."""
    tmp = dest + ".partial"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            expected = int(r.headers.get("Content-Length") or 0)
            with open(tmp, "wb") as f:
                shutil.copyfileobj(r, f, 1 << 20)
        if expected and os.path.getsize(tmp) != expected:
            raise IOError(f"size mismatch: got {os.path.getsize(tmp)}, "
                          f"expected {expected}")
        os.replace(tmp, dest)
        return dest
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def resolve_checkpoint(name_or_path: str) -> str:
    """A local checkpoint location for a path (returned as it is), a URL or
    an alias such as ``QM9_small_homo``; a URL or alias not in the cache is
    downloaded into it."""
    if os.path.exists(name_or_path):
        return name_or_path

    if name_or_path.startswith(("http://", "https://")):
        url = name_or_path
        fname = url.rsplit("/", 1)[-1]
    else:
        parts = name_or_path.split("_")
        if len(parts) != 3:
            raise ValueError(
                f"{name_or_path!r} is neither a path, URL, nor a "
                "'{task}_{size}_{label}' alias")
        task, size, label = parts
        if task not in ALIAS_SIZES:
            raise ValueError(f"unknown task {task!r}; known: "
                             f"{sorted(ALIAS_SIZES)}")
        if size not in ALIAS_SIZES[task]:
            raise ValueError(
                f"task {task} has sizes {ALIAS_SIZES[task]}, not {size!r}")
        if task == "QM9" and label not in _QM9_LABELS:
            raise ValueError(f"unknown QM9 label {label!r}")
        url = HUB_URL.format(task=task, size=size, label=label)
        fname = f"{task}_{size}_{label}.ckpt"

    dest = os.path.join(_cache_dir(), fname)
    if os.path.exists(dest):
        return dest
    return download_with_fallback([url] + _mirror_urls(url), dest)


def _mirror_urls(primary: str) -> list:
    """More candidates from ``$GOTENNET_TPU_CHECKPOINT_MIRRORS`` (base URLs,
    comma-separated; the primary's path after the host is appended)."""
    bases = os.environ.get("GOTENNET_TPU_CHECKPOINT_MIRRORS", "")
    if not bases:
        return []
    path = urlparse(primary).path.lstrip("/")
    return [b.rstrip("/") + "/" + path for b in bases.split(",") if b]


def download_with_fallback(urls: list, dest: str) -> str:
    """Each URL in turn: a HEAD request, the download, a check that the file
    is there and not empty; any failure falls through to the next, and the
    last one raises ``FileNotFoundError`` naming every source."""
    log = get_logger()
    last_error = None
    for i, url in enumerate(urls):
        log.info("download attempt %d/%d: %s", i + 1, len(urls), url)
        try:
            with urllib.request.urlopen(
                    urllib.request.Request(url, method="HEAD"), timeout=10):
                pass
            download_file(url, dest)
            if not os.path.exists(dest):
                raise FileNotFoundError("file missing after download")
            if os.path.getsize(dest) == 0:
                os.remove(dest)
                raise FileNotFoundError("downloaded file is empty")
            return dest
        except Exception as e:  # noqa: BLE001 - every failure falls through
            last_error = e
            log.warning("download from %s failed: %s", url, e)
    raise FileNotFoundError(
        f"failed to download {os.path.basename(dest)} from all {len(urls)} "
        f"source(s): {', '.join(urls)}") from last_error
