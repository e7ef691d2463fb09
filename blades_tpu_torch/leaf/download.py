"""Google Drive dataset downloader (LEAF FEMNIST et al.).

Reference: ``src/blades/models/utils/download_util.py`` — a requests-based
Google Drive fetch (id -> file) with the "download_warning" confirm-token
dance, used to pull LEAF dataset archives (FEMNIST id hardcoded in its
``__main__``). Rewritten on urllib (requests is not a dependency here) as
an importable function plus the same extract-to-data-dir convenience.

Deviations from the reference, both deliberate:

- Drive retired the ``download_warning`` cookie years ago; the virus-scan
  interstitial is now an HTML form. We keep the cookie path (cheap, and
  matches the reference) but ALSO parse the modern form's hidden fields
  and retry against its action URL, and we verify the final payload is not
  HTML instead of silently saving the interstitial as the dataset.
- Offline environments (``BLADES_TPU_OFFLINE=1``) get an actionable error
  with the manual-placement path instead of a hang
  (``blades_tpu_torch/utils/fetch.py``).

Counterpart: ``blades_tpu/leaf/download.py``, copied line for line (the
port imports nothing of the JAX package), so that Python's seeded
``random`` gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import http.cookiejar
import os
import re
import urllib.parse
import urllib.request
import zipfile

FEMNIST_GDRIVE_ID = "1rdRFbKeT9woS48Fmmo2mgJWDWSexhGeS"  # ref __main__
_BASE = "https://docs.google.com/uc?export=download"


def _parse_confirm_form(html: str):
    """(action_url, params) from Drive's virus-scan interstitial form."""
    m = re.search(r'<form[^>]+action="([^"]+)"', html)
    if not m:
        return None
    action = m.group(1)
    params = dict(
        re.findall(r'<input[^>]+name="([^"]+)"[^>]+value="([^"]*)"', html)
    )
    return action, params


def download_file_from_google_drive(file_id: str, destination: str) -> str:
    """Fetch a publicly shared Drive file to ``destination``.

    Follows the reference's flow (``download_util.py:7-35``) — GET, then
    retry with the ``download_warning`` cookie as ``confirm`` — extended
    with the modern HTML-form confirm dance and an is-it-really-a-file
    check (an interstitial saved as the dataset is worse than an error).
    """
    from blades_tpu_torch.utils.fetch import fetch_to

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(urllib.request.HTTPCookieProcessor(jar))

    def open_stream():
        resp = opener.open(_BASE + "&" + urllib.parse.urlencode({"id": file_id}))
        token = next(
            (c.value for c in jar if c.name.startswith("download_warning")), None
        )
        if token:
            resp = opener.open(
                _BASE
                + "&"
                + urllib.parse.urlencode({"id": file_id, "confirm": token})
            )
        head = resp.read(512)
        if head.lstrip()[:15].lower().startswith((b"<!doctype html", b"<html")):
            # virus-scan interstitial: resubmit via its form
            html = (head + resp.read()).decode("utf-8", "replace")
            form = _parse_confirm_form(html)
            if form is None:
                raise RuntimeError(
                    "Drive returned an HTML page with no download form "
                    "(file may be private or quota-limited)"
                )
            action, params = form
            resp = opener.open(action + "?" + urllib.parse.urlencode(params))
            head = resp.read(512)
            if head.lstrip()[:15].lower().startswith(
                (b"<!doctype html", b"<html")
            ):
                raise RuntimeError("Drive confirm flow still returned HTML")

        # re-join the sniffed head with the remaining stream
        import io

        class _Rejoined(io.RawIOBase):
            def __init__(self, head_bytes, rest):
                self._head = head_bytes
                self._rest = rest

            def read(self, n=-1):
                if self._head:
                    out, self._head = self._head, b""
                    return out
                return self._rest.read(n)

            def close(self):
                self._rest.close()
                super().close()

        return _Rejoined(head, resp)

    return fetch_to(destination, open_stream, f"Drive id {file_id!r}")


def download_and_extract(
    file_id: str, data_dir: str, archive_name: str = "dataset.zip"
) -> str:
    """Reference ``__main__`` flow as a function: download the archive,
    unzip into ``data_dir``, remove the archive. An archive already present
    at the destination is used without any network touch."""
    os.makedirs(data_dir, exist_ok=True)
    archive = os.path.join(data_dir, archive_name)
    if not os.path.exists(archive):
        download_file_from_google_drive(file_id, archive)
    try:
        with zipfile.ZipFile(archive) as z:
            z.extractall(data_dir)
    except zipfile.BadZipFile as e:
        # remove the bad archive so the next call re-downloads instead of
        # wedging forever
        os.remove(archive)
        raise RuntimeError(
            f"{archive} is not a valid zip (removed); re-run to re-download, "
            "or place a good archive there manually."
        ) from e
    os.remove(archive)
    return data_dir
