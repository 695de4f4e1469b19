"""Legacy dataset downloader, parity with the reference's util/get_data.py
(downloads the original CycleGAN/pix2pix benchmark archives; unrelated to
the vertebra flow, kept for inventory completeness).

A copy of healthivert_tpu/utils/get_data.py on stdlib urllib (no
requests/bs4). A failed download of both archive kinds raises RuntimeError.
Tar archives extract with tarfile's "data" filter, which refuses members
that would land outside `save_path`.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
import zipfile

CYCLEGAN_URL = "http://efrosgans.eecs.berkeley.edu/cyclegan/datasets"
PIX2PIX_URL = "http://efrosgans.eecs.berkeley.edu/pix2pix/datasets"


class GetData:
    def __init__(self, technique: str = "cyclegan", verbose: bool = True):
        self.url = {"cyclegan": CYCLEGAN_URL, "pix2pix": PIX2PIX_URL}[technique.lower()]
        self.verbose = verbose

    def get(self, save_path: str, dataset: str):
        os.makedirs(save_path, exist_ok=True)
        for ext in (".tar.gz", ".zip"):
            url = f"{self.url}/{dataset}{ext}"
            archive = os.path.join(save_path, dataset + ext)
            try:
                if self.verbose:
                    print(f"downloading {url}")
                urllib.request.urlretrieve(url, archive)
            except OSError as e:
                if self.verbose:
                    print(f"  failed ({e}); this environment may have no egress")
                continue
            if ext == ".zip":
                with zipfile.ZipFile(archive) as z:
                    z.extractall(save_path)
            else:
                with tarfile.open(archive) as t:
                    t.extractall(save_path, filter="data")
            os.remove(archive)
            return os.path.join(save_path, dataset)
        raise RuntimeError(f"could not download dataset {dataset!r}")
