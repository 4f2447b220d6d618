"""Declarative CSS-selector extraction templates.

The reference's only real config system (SURVEY.md §5.6): ``templates.json``
entries of ``{field: selector | {selector, attribute, index, inner}}``,
registered at runtime (``01_server.py:29-41``) and interpreted recursively by
``extract_elements`` (``03_worker_multi.py:107-133``, ``local.py:61-83``,
``10_btc_articles.py:152-176``).  This module reproduces that dialect
exactly:

- a **plain string** spec is a selector; the first match's stripped text is
  taken, ``''`` when absent (``03_worker_multi.py:140-145``);
- a **dict** spec has ``selector`` (CSS, required), ``attribute`` (default
  ``'text'`` → stripped text, otherwise an HTML attribute,
  ``local.py:63,77-80``), ``index`` (a **list** of element indices, falsy →
  all matches, ``03_worker_multi.py:115-117``) and ``inner`` (a nested
  *spec dict* applied to each selected element, ``local.py:73-75``);
- dict specs always return a **list** (one entry per selected element,
  nested lists for ``inner``); no matches → ``[]``;
- per-field errors degrade to ``''`` rather than failing the page
  (``03_worker_multi.py:148-150``).

``make_template_extractor`` turns a template into a callable satisfying the
``extract_article_data(soup) -> dict`` plugin contract so template-driven
sites plug into the same pipeline as hand-written extractors.

The port's copy of the reference's ``extractors/template.py``, on the
port's HTML tree (``core/soup.py``), whose CSS support is a subset of
soupsieve's.  Since a field's error reads as ``''``, a selector outside
that subset would read as an empty field; so ``make_template_extractor``
(and with it ``TemplateStore.add`` and ``register_all``) parses every
selector of a template first and raises ``NotImplementedError`` naming the
one it cannot run.  A selector that is not valid CSS still reads as
``''``, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from advanced_scrapper_tpu_torch.core.soup import SelectorSyntaxError, compile_selector
from advanced_scrapper_tpu_torch.extractors import register


def extract_elements(spec: dict, parent) -> list:
    """Interpret one dict spec against a soup element (reference dialect)."""
    selector = spec["selector"]
    attribute = spec.get("attribute", "text")
    index = spec.get("index")
    inner = spec.get("inner")

    elements = parent.select(selector)
    if not elements:
        return []
    if index:
        elements = [elements[i] for i in index if i < len(elements)]
    values = []
    for el in elements:
        if inner:
            values.append(extract_elements(inner, el))
        elif attribute == "text":
            values.append(el.get_text(strip=True))
        else:
            values.append(el.get(attribute, ""))
    return values


def extract_with_template(soup, template: dict) -> dict:
    """Apply a full ``{field: spec}`` template to a page."""
    out: dict[str, Any] = {}
    for field, spec in template.items():
        try:
            if isinstance(spec, dict):
                out[field] = extract_elements(spec, soup)
            elif isinstance(spec, str):
                el = soup.select_one(spec)
                out[field] = el.get_text(strip=True) if el is not None else ""
            else:
                raise TypeError(
                    f"template spec must be str or dict, got {type(spec)}"
                )
        except TypeError:
            raise
        except Exception:
            out[field] = ""
    return out


def _selectors(spec):
    """Every selector string of one field's spec (nested ``inner`` specs
    too)."""
    if isinstance(spec, str):
        yield spec
    elif isinstance(spec, dict):
        if isinstance(spec.get("selector"), str):
            yield spec["selector"]
        if isinstance(spec.get("inner"), dict):
            yield from _selectors(spec["inner"])


def check_template(template: dict) -> None:
    """Parse every selector of ``template`` up front: one outside the
    tree's CSS subset raises ``NotImplementedError`` here, never reads as an
    empty field.  Invalid CSS is left to the field (``''``)."""
    for spec in template.values():
        for selector in _selectors(spec):
            try:
                compile_selector(selector)
            except SelectorSyntaxError:
                pass


def make_template_extractor(template: dict) -> Callable:
    check_template(template)

    def extract_article_data(soup) -> dict:
        return extract_with_template(soup, template)

    return extract_article_data


class TemplateStore:
    """Persisted named templates (successor of ``templates.json`` +
    ``POST /add_template``, ``01_server.py:13-41``)."""

    def __init__(self, path: str = "templates.json"):
        self.path = path
        self._templates: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                self._templates = json.load(f)

    def add(self, name: str, template: dict) -> None:
        check_template(template)
        self._templates[name] = template
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(self._templates, f, indent=2)
        register(name, make_template_extractor(template))

    def get(self, name: str) -> dict:
        return self._templates[name]

    def names(self) -> list[str]:
        return sorted(self._templates)

    def register_all(self) -> None:
        for name, tpl in self._templates.items():
            register(name, make_template_extractor(tpl))
