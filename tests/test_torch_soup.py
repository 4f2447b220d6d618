"""The port's HTML tree (``core/soup.py``) against bs4 4.15 with
``html.parser``, the reference's parser.

On the three fixtures, on hand-written traps (character references the
two decoders differ on, ``li`` nesting, void and unmatched tags, script,
style, template and ruby text, whitespace runs, ``pre``) and on seeded
random documents (nesting, unclosed and unmatched tags, void tags,
entities, comments, CDATA, script/style, multi-class attributes): the
whole tree (names, attributes, typed strings), ``get_text`` with and
without a separator and strip, ``find_all``/``find`` and ``select`` over a
fixed list of selectors that covers the subset.  Selectors outside the
subset raise ``NotImplementedError`` when parsed, and when a template is
built."""

from __future__ import annotations

import os

import numpy as np
import pytest
from bs4 import BeautifulSoup

from advanced_scrapper_tpu_torch.core import soup as port_soup
from advanced_scrapper_tpu_torch.core.soup import SelectorSyntaxError, Soup, compile_selector

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE_PAGES = {name: open(os.path.join(FIXTURES, name), encoding="utf-8").read()
                 for name in sorted(os.listdir(FIXTURES)) if name.endswith(".html")}

TRAPS = [
    "<p>a &amp b &copy; &#65 &bogus; &lt;</p>",
    "<ul><li>1<li>2</ul>",
    "<div class='body x'><ul><li>a</li><li>b</li></ul></div><script>var x = 1 < 2;</script>"
    "<!-- c --><style>p { color: red }</style>",
    "<p>a<br>b</br>c</p><p>x</br>y</p>",
    "<pre>  \n </pre><p> </p>\n<p>\n\n</p><textarea>  </textarea>",
    "&#128;&#129;&#0;&#x110000;&#xd800;&#65x;&#x41;&#X42;&#150;&#xfffe;",
    "<template><p>t</p></template><ruby>a<rt>b</rt><rp>(</rp></ruby>",
    "<![CDATA[cd]]><!DOCTYPE html><?pi x?><!ELEMENT br EMPTY>tail",
    "<div/><br/>x<img src=a>y</img>z<hr></hr>",
    "<a href='https://finance.yahoo.com/quote/AAPL?p=AAPL' rel='nofollow noopener'>A</a>"
    "<td headers='h1 h2'>c</td><p class=''>e</p><p class='  a  b '>f</p>",
    "<div><p>unclosed<div><span>deep</div></p></span>after</div>",
    "<P CLASS='Up'>Upper</P><p id=x id=y data-A=1>dup</p>",
    "<table><tr><th>h</th><td>1<tr><td>2</table>",
    "text only &amp; &#x263a; &notin &notit; &amp",
    "",
]

SELECTORS = [
    "div", "p", "li", "a", "*", "div.body", "div.body li", "ul > li", "li + li", "li ~ li",
    ".a", ".a.b", "p.a", "#x", "div#main", "[href]", "a[href]", "[class=a]", "[class='a b']",
    "[href^=https]", "[href$='.html']", "[href*=quote]", "[data-a]", "[type=TEXT]",
    "div p", "div > p", "div > p > a", "ul li, ol li", "p, a", "h1 + p", "table tr td",
    "* > p", "body *", "div.cover-title", "a.subtle-link.fin-size-small", "div.body-wrap a",
    "time[datetime]", "span ~ span", "td + td", "tr > th", "[id]", "div\t>\np",
]


def canon(node):
    """A node as plain data: a tag's name, attributes and children; a
    string's class name and text."""
    if isinstance(node, str):
        return (type(node).__name__, str(node))
    attrs = {k: list(v) if isinstance(v, list) else v for k, v in node.attrs.items()}
    return (node.name, attrs, [canon(c) for c in node.contents])


def texts(tags) -> list:
    return [(t.name, t.get_text(), t.get_text("|", strip=True),
             {k: list(v) if isinstance(v, list) else v for k, v in t.attrs.items()})
            for t in tags]


def random_document(rng: np.random.RandomState, size: int) -> str:
    """Markup a browser would shrug at: random nesting of block and inline
    tags (half of them left unclosed), stray end tags, void tags in both
    forms, multi-class and duplicate attributes, entities good and bad,
    comments, CDATA, script and style, whitespace runs."""
    names = ("div", "p", "span", "ul", "ol", "li", "a", "b", "table", "tr", "td", "th", "pre",
             "section", "template", "ruby", "rt", "textarea", "h1")
    words = ("alpha", "beta", "&amp;", "&lt;b&gt;", "&copy;", "&bogus;", "&#65;", "&#x263a;",
             "&#150;", "&#0;", "&nbsp;", "AT&T", "x &amp y", "  ", "\n", "\t \n ", "a<b", "5 > 3")
    classes = ("a", "b", "body", "cover-title", "x", "A")
    out, open_tags = [], []
    for _ in range(size):
        u = rng.rand()
        if u < 0.30:
            name = names[rng.randint(len(names))]
            attrs = []
            if rng.rand() < 0.5:
                attrs.append("class='" + " ".join(
                    classes[rng.randint(len(classes))] for _ in range(rng.randint(0, 4))) + "'")
            if rng.rand() < 0.2:
                attrs.append(f"id=x{rng.randint(3)}")
            if rng.rand() < 0.2:
                attrs.append(f"href='https://finance.yahoo.com/quote/T{rng.randint(5)}"
                             f"{'.html' if rng.rand() < 0.5 else ''}'")
            if rng.rand() < 0.1:
                attrs.append("type=Text data-a disabled")
            out.append(f"<{name}{' ' if attrs else ''}{' '.join(attrs)}>")
            open_tags.append(name)
        elif u < 0.45 and open_tags:
            # close the innermost tag, one further out, or one never opened
            v = rng.rand()
            if v < 0.6:
                out.append(f"</{open_tags.pop()}>")
            elif v < 0.8:
                out.append(f"</{open_tags[rng.randint(len(open_tags))]}>")
            else:
                out.append(f"</{names[rng.randint(len(names))]}>")
        elif u < 0.52:
            out.append(("<br>", "<br/>", "<img src='i.png'>", "<hr/>", "</br>", "<input>")[
                rng.randint(6)])
        elif u < 0.56:
            out.append(("<!-- note -->", "<![CDATA[raw < data]]>", "<script>if (a < b) x();</script>",
                        "<style>p > a { color: red }</style>", "<?php echo 1 ?>")[rng.randint(5)])
        else:
            out.append(words[rng.randint(len(words))])
    return "".join(out)


DOCUMENTS = {**FIXTURE_PAGES, **{f"trap{i}": t for i, t in enumerate(TRAPS)},
             **{f"random{i}": random_document(np.random.RandomState(i), 40 + 12 * i)
                for i in range(24)}}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_tree_matches_bs4(name):
    markup = DOCUMENTS[name]
    ref, got = BeautifulSoup(markup, "html.parser"), Soup(markup)
    assert canon(got) == canon(ref)
    for args in ((), ("\n", True), ("|", False), ("", True)):
        assert got.get_text(*args) == ref.get_text(*args), args
    for tag in ("li", "p", "a", "div", "td", ["th", "td"], ["ul", "ol"], None):
        assert texts(got.find_all(tag)) == texts(ref.find_all(tag)), tag
        g, r = got.find(tag), ref.find(tag)
        assert (g is None) == (r is None) and (g is None or texts([g]) == texts([r]))
    assert texts(got.find_all("a", href=True)) == texts(ref.find_all("a", href=True))
    for a, b in zip(got.find_all(["ul", "ol", "div", "tr"]), ref.find_all(["ul", "ol", "div", "tr"])):
        assert texts(a.find_all(["li", "td"], recursive=False)) == texts(
            b.find_all(["li", "td"], recursive=False))
        assert [a.has_attr(k) for k in ("class", "id", "href")] == [
            b.has_attr(k) for k in ("class", "id", "href")]


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_select_matches_soupsieve(name):
    markup = DOCUMENTS[name]
    ref, got = BeautifulSoup(markup, "html.parser"), Soup(markup)
    for sel in SELECTORS:
        assert texts(got.select(sel)) == texts(ref.select(sel)), sel
        g, r = got.select_one(sel), ref.select_one(sel)
        assert (g is None) == (r is None), sel
    # selection from inner elements reaches ancestors past the scope
    for a, b in zip(got.find_all("div")[:4], ref.find_all("div")[:4]):
        for sel in ("div li", "div p", "* > p", "p ~ p", "body div"):
            assert texts(a.select(sel)) == texts(b.select(sel)), sel


def test_issue_traps_read_as_bs4_does():
    got = Soup("<p>a &amp b &copy; &#65 &bogus; &lt;</p>")
    assert got.get_text() == "a & b © A &bogus <"
    ul = Soup("<ul><li>1<li>2</ul>")
    assert [li.get_text() for li in ul.find_all("li")] == ["12", "2"]
    page = Soup("<div class='body'><ul><li>1<li>2</ul></div>")
    assert len(page.select("div.body li")) == 2 and len(page.select("ul > li")) == 1
    assert Soup("<p>x<script>s</script><style>t</style><!--c--></p>").get_text() == "x"


def test_numeric_and_named_references_match_bs4():
    nums = [*range(0, 0x200), 0xD7FF, 0xD800, 0xDFFF, 0xE000, 0xFDD0, 0xFFFE, 0xFFFF,
            0x10FFFF, 0x110000, 10**9]
    markup = "".join(f"<i>&#{n};</i><i>&#x{n:x};</i>" for n in nums)
    names = sorted({n.rstrip(";") for n in port_soup.html5})[::7] + ["bogus", "amp", "AMP"]
    markup += "".join(f"<b>&{n};</b><b>&{n}</b>" for n in names)
    ref, got = BeautifulSoup(markup, "html.parser"), Soup(markup)
    assert [t.get_text() for t in got.find_all(["i", "b"])] == [
        t.get_text() for t in ref.find_all(["i", "b"])]


UNSUPPORTED = ["p:first-child", "li:nth-child(2)", "[href!=x]", "[href~=x]", "[lang|=en]",
               "[href=x i]", "ns|p", "p\\.q", "div:not(.a)", ":root", "a[href='a\\'b']"]
INVALID = ["", "   ", "div >", "> p", "p,", ", p", "p > > a", ".a div.b +", "div  > p", "a  ~ b",
           "div..a", "#1a", ".1a", "[href", "[href=]", "[=x]", "a[", "div#", "a]", "p!", "[a=1]",
           "[a=b c]", "$x", "p.-1"]


@pytest.mark.parametrize("sel", UNSUPPORTED)
def test_selector_outside_the_subset_raises_when_parsed(sel):
    compile_selector.cache_clear()
    with pytest.raises(NotImplementedError, match="outside the supported subset"):
        compile_selector(sel)
    with pytest.raises(NotImplementedError):
        Soup("<p>x</p>").select(sel)
    BeautifulSoup("<p>x</p>", "html.parser").select(sel)  # soupsieve reads it


@pytest.mark.parametrize("sel", INVALID)
def test_invalid_css_is_a_syntax_error(sel):
    with pytest.raises(SelectorSyntaxError):
        compile_selector(sel)


def test_template_with_an_unsupported_selector_raises_when_built(tmp_path):
    """The template extractor swallows a field's error into ``''``, so the
    port parses every selector when the template is built: a selector it
    cannot run never reads as an empty field.  Invalid CSS still reads as
    ``''``, as in the reference."""
    from advanced_scrapper_tpu.extractors import template as ref_template
    from advanced_scrapper_tpu_torch.extractors import template

    bad = {"title": "h1", "items": {"selector": "ul", "inner": {"selector": "li:nth-child(2)"}}}
    with pytest.raises(NotImplementedError, match="nth-child"):
        template.make_template_extractor(bad)
    store = template.TemplateStore(str(tmp_path / "templates.json"))
    with pytest.raises(NotImplementedError):
        store.add("bad", bad)
    assert store.names() == [] and not (tmp_path / "templates.json").exists()
    page = "<h1>T</h1><ul><li>a</li><li>b</li></ul>"
    ref = ref_template.make_template_extractor(bad)(BeautifulSoup(page, "html.parser"))
    assert ref["items"] == [["b"]]  # soupsieve runs it; the port refuses up front
    invalid = {"title": "h1 >", "other": {"selector": "[href"}, "ok": "h1"}
    got = template.make_template_extractor(invalid)(Soup(page))
    assert got == ref_template.make_template_extractor(invalid)(
        BeautifulSoup(page, "html.parser")) == {"title": "", "other": "", "ok": "T"}
