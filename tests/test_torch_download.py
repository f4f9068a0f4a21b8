"""tpulab_torch's ``utils/download`` held against tpulab's, over a local
HTTP server on 127.0.0.1 (nothing leaves the machine): a fetch streams to
disk and names the file from the URL, an existing file is returned with no
request, an HTTP error or a refused connection gives None and leaves no
partial file, and an image link extends an ``ImageDataset``."""

import http.server
import os
import shutil
import threading

import pytest

from tpulab.utils.download import download_file as jax_download_file

from tpulab_torch.harness.processors.imageset import ImageDataset
from tpulab_torch.utils.download import download_file

pytest.importorskip("requests")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOB = bytes(range(256)) * 300  # ~77 KB: spans chunks


@pytest.fixture(scope="module")
def httpd():
    hits = []
    png = b"\x89PNG\r\n\x1a\n" + bytes(64)  # the dataset lists paths, it reads no pixel

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            body = {"/files/blob.bin": BLOB, "/img.png": png}.get(self.path)
            if body is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", hits, png
    finally:
        srv.shutdown()


@pytest.mark.parametrize("filename", [None, "renamed.dat"])
def test_fetch_equals_tpulab(tmp_path, httpd, filename):
    base, _, _ = httpd
    got = download_file(f"{base}/files/blob.bin", str(tmp_path / "t"), filename=filename)
    want = jax_download_file(f"{base}/files/blob.bin", str(tmp_path / "j"), filename=filename)
    assert os.path.basename(got) == os.path.basename(want) == (filename or "blob.bin")
    assert open(got, "rb").read() == open(want, "rb").read() == BLOB
    assert sorted(os.listdir(tmp_path / "t")) == [os.path.basename(got)]


def test_existing_file_short_circuits(tmp_path, httpd):
    base, hits, _ = httpd
    d = tmp_path / "dl"
    d.mkdir()
    (d / "blob.bin").write_bytes(b"local copy")
    n0 = len(hits)
    assert download_file(f"{base}/files/blob.bin", str(d)) == str(d / "blob.bin")
    assert (d / "blob.bin").read_bytes() == b"local copy" and len(hits) == n0


@pytest.mark.parametrize("path", ["/missing.bin", None], ids=["http-404", "refused"])
def test_failure_returns_none_and_no_partial(tmp_path, httpd, capsys, path):
    base, _, _ = httpd
    url = f"{base}{path}" if path else "http://127.0.0.1:9/nope.bin"
    assert download_file(url, str(tmp_path / "dl")) is None
    assert jax_download_file(url, str(tmp_path / "jl")) is None
    assert list((tmp_path / "dl").iterdir()) == []
    assert capsys.readouterr().out.count(f"[download_file] skipped {url}") == 2


def test_image_link_extends_the_dataset(tmp_path, httpd):
    base, _, png = httpd
    data = tmp_path / "data"
    shutil.copytree(os.path.join(REPO, "data/lab2/data"), data)
    before = len(ImageDataset(str(data), str(tmp_path / "o0")).paths)
    ds = ImageDataset(str(data), str(tmp_path / "o"), extra_links_to_png=[f"{base}/img.png"])
    assert len(ds.paths) == before + 1
    new = ds.paths[-1]
    assert os.path.dirname(new) == str(data) and new.endswith(".png")
    assert open(new, "rb").read() == png
