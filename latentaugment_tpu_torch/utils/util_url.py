"""URL-to-cache-path helpers (counterpart:
latentaugment_tpu/utils/util_url.py:22-36). A detector URL resolves to
`<cache_dir>/<md5(url)>_<basename>`; nothing here downloads. The cache
root is this package's own (LATENTAUGMENT_CACHE_DIR, else
~/.cache/latentaugment_tpu_torch), read at call time."""

import hashlib
import os
import re


def cache_dir():
    return os.environ.get(
        "LATENTAUGMENT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "latentaugment_tpu_torch"))


def is_url(s):
    return isinstance(s, str) and re.match(r"^[a-z]+://", s) is not None


def make_cache_dir_path(*paths):
    """Join paths under the cache root."""
    return os.path.join(cache_dir(), *paths)


def url_cache_path(url, cache_dir_=None):
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    basename = url.split("/")[-1].split("?")[0] or "download"
    return os.path.join(cache_dir_ or cache_dir(), f"{url_md5}_{basename}")
