"""Extractor plugin boundary, and the streaming batch backend behind it.

The port's copy of the reference's ``extractors/__init__.py``.  The
original scraper's L2→L3 interface is
``import_module(f"extractors.{website}")`` plus the single-function
contract ``extract_article_data(soup) -> dict``
(``constant_rate_scrapper.py:301``, ``extractors/yfin.py:7``).  This
package preserves both: any module here (or any registered callable)
exposing ``extract_article_data`` is a site plugin; ``soup`` is the port's
HTML tree (``core/soup.py:Soup``).  The device batch backend
(``tpu_batch``) plugs in *behind* this boundary.
"""

from __future__ import annotations

from importlib import import_module
from typing import Callable, Protocol

#: the plugin output schema (ref constant_rate_scrapper.py:320-330): every
#: ``extract_article_data`` dict writes these columns plus ``url``.  Defined
#: at the extractor boundary — pipeline AND net both consume them, and
#: ``net/`` must not import ``pipeline/``.
SUCCESS_FIELDS = [
    "url",
    "datetime",
    "ticker_symbols",
    "author",
    "source",
    "source_url",
    "title",
    "article",
]
FAILED_FIELDS = ["url", "error"]

_REGISTRY: dict[str, Callable] = {}


class Extractor(Protocol):
    def __call__(self, soup) -> dict: ...


def register(name: str, fn: Callable) -> None:
    """Register a non-module extractor (e.g. a template-driven one)."""
    _REGISTRY[name] = fn


def load_extractor(website: str) -> Callable:
    """Resolve a site name to its ``extract_article_data`` callable.

    Mirrors the original scraper's dynamic import
    (``constant_rate_scrapper.py:299-304``) with a registry layered on top
    so declarative-template extractors (``template.py``) can be addressed by
    name too.
    """
    if website in _REGISTRY:
        return _REGISTRY[website]
    mod = import_module(f"advanced_scrapper_tpu_torch.extractors.{website}")
    return mod.extract_article_data
