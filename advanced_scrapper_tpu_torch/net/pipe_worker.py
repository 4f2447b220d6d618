"""Subprocess worker: line-oriented stdin/stdout JSON protocol.

The port's copy of the reference's ``net/pipe_worker.py``: one process,
one transport; the parent writes a URL per line to stdin, the worker
replies with one JSON result line on stdout (or a JSON error object on
stderr).  Pages are parsed by the port's HTML tree (``core/soup.py``).
Configuration arrives as a JSON argv blob:

    {"website": "yfin"}                     # plugin extractor
    {"template": {...}}                     # declarative template
    {"transport": "mock", "pages": {...}}   # test transport

Run as ``python -m advanced_scrapper_tpu_torch.net.pipe_worker '<config
json>'``.  A worker never imports torch: the package root imports it
lazily, and nothing a worker runs needs it.
"""

from __future__ import annotations

import json
import sys

from advanced_scrapper_tpu_torch.core.soup import Soup


def run_worker(config: dict, stdin=None, stdout=None, stderr=None) -> None:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr

    from advanced_scrapper_tpu_torch.net.transport import make_transport

    transport = make_transport(
        config.get("transport", "auto"), pages=config.get("pages")
    )
    if "template" in config:
        from advanced_scrapper_tpu_torch.extractors.template import make_template_extractor

        extractor = make_template_extractor(config["template"])
    else:
        from advanced_scrapper_tpu_torch.extractors import load_extractor

        extractor = load_extractor(config.get("website", "yfin"))

    for line in stdin:
        url = line.strip()
        if not url:
            continue
        try:
            html = transport.fetch(url)
            data = extractor(Soup(html))
            data["url"] = url
            stdout.write(json.dumps(data) + "\n")
            stdout.flush()
        except Exception as e:
            stderr.write(json.dumps({"url": url, "error": str(e)}) + "\n")
            stderr.flush()
    transport.close()


def main() -> int:
    config = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    run_worker(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
