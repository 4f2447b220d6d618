"""A stdlib HTML tree: the subset of BeautifulSoup that the extractors use.

The reference parses every page with ``bs4.BeautifulSoup(html,
"html.parser")``; the port imports only torch, numpy and the standard
library, so it builds its own tree on the same ``html.parser.HTMLParser``
event stream, with bs4 4.15's tree semantics for that parser:

- character references are decoded by the tree, not by the parser
  (``convert_charrefs=False``), as bs4's ``BeautifulSoupHTMLParser`` does:
  a named reference missing from the HTML5 table reads as ``&name`` (the
  semicolon dropped), a numeric one in 0x80-0x9F as its Windows-1252
  character, 0, surrogates and numbers past U+10FFFF as U+FFFD;
- an end tag pops to the nearest open tag of its name, an unmatched one is
  ignored; a void element closes at once (a later ``</br>`` after a
  ``<br>`` is swallowed); nothing closes implicitly (``<li>1<li>2`` nests
  the second item in the first);
- a run of ASCII whitespace between two tags becomes one ``"\\n"`` (when it
  holds a newline) or one ``" "``, except inside ``pre`` and ``textarea``;
- ``class`` and the other multi-valued attributes are lists;
- strings are typed: ``get_text`` keeps plain text and CDATA and leaves out
  comments, doctypes, declarations, processing instructions and the text
  of ``script``, ``style``, ``template``, ``rt`` and ``rp`` (a tag of those
  names keeps its own kind).

CSS selection covers type, ``*``, ``.class``, ``#id``, ``[attr]``,
``[attr=v]``, ``^=``, ``$=``, ``*=``, compound selectors, the descendant,
``>``, ``+`` and ``~`` combinators and comma groups, with soupsieve's
matching rules for HTML (ancestors reached past the scope element, the
``type`` attribute's value compared without case).  Any other selector
raises :class:`NotImplementedError` naming it when it is parsed
(:func:`compile_selector`); a selector that is not valid CSS raises
:class:`SelectorSyntaxError`.
"""

from __future__ import annotations

import re
from functools import lru_cache
from html.entities import html5
from html.parser import HTMLParser

__all__ = [
    "CData", "Comment", "Declaration", "Doctype", "NavigableString", "ProcessingInstruction",
    "Script", "SelectorSyntaxError", "Soup", "Stylesheet", "Tag", "TemplateString",
    "compile_selector",
]


class NavigableString(str):
    """A text node; its class says what kind of text it is."""

    name = None
    parent = None


class Comment(NavigableString):
    pass


class CData(NavigableString):
    pass


class Doctype(NavigableString):
    pass


class Declaration(NavigableString):
    pass


class ProcessingInstruction(NavigableString):
    pass


class Script(NavigableString):
    pass


class Stylesheet(NavigableString):
    pass


class TemplateString(NavigableString):
    pass


class RubyTextString(NavigableString):
    pass


class RubyParenthesisString(NavigableString):
    pass


#: tags whose text is its own kind of string (bs4's DEFAULT_STRING_CONTAINERS)
STRING_CONTAINERS = {
    "rt": RubyTextString, "rp": RubyParenthesisString, "style": Stylesheet,
    "script": Script, "template": TemplateString,
}
#: the kinds a tag outside those names reads in ``get_text``
MAIN_CONTENT = (NavigableString, CData)
VOID_ELEMENTS = frozenset((
    "area", "base", "br", "col", "embed", "hr", "img", "input", "keygen", "link", "menuitem",
    "meta", "param", "source", "track", "wbr", "basefont", "bgsound", "command", "frame",
    "image", "isindex", "nextid", "spacer"))
PRESERVE_WHITESPACE = frozenset(("pre", "textarea"))
#: attributes whose value is a whitespace-separated list, by tag ("*": all)
MULTI_VALUED = {
    "*": {"class", "accesskey", "dropzone"}, "a": {"rel", "rev"}, "link": {"rel", "rev"},
    "td": {"headers"}, "th": {"headers"}, "form": {"accept-charset"}, "object": {"archive"},
    "area": {"rel"}, "icon": {"sizes"}, "iframe": {"sandbox"}, "output": {"for"},
}


@lru_cache(maxsize=None)
def _multi_valued(name: str) -> frozenset:
    return frozenset(MULTI_VALUED["*"] | MULTI_VALUED.get(name, set()))


ASCII_SPACES = frozenset("\x20\x0a\x09\x0c\x0d")
_NON_WS = re.compile(r"\S+")
ROOT_NAME = "[document]"


def _entity_table() -> dict[str, str]:
    """HTML5 named references without their semicolons, the first spelling
    of a name in sorted order winning (bs4's ``EntitySubstitution``)."""
    table: dict[str, str] = {}
    for name, char in sorted(html5.items()):
        table.setdefault(name[:-1] if name.endswith(";") else name, char)
    return table


ENTITIES = _entity_table()
_DEC_REF = re.compile("^([0-9]+)(.*)")
_HEX_REF = re.compile("^([0-9a-f]+)(.*)")


def _numeric_reference(number: int) -> str:
    if number == 0 or number > 0x10FFFF or 0xD800 <= number <= 0xDFFF:
        return "\ufffd"
    if 0x80 <= number <= 0x9F:
        try:
            return bytes([number]).decode("cp1252")
        except UnicodeDecodeError:
            pass
    return chr(number)


def _dereference(name: str) -> tuple[str, str]:
    """A numeric reference's character and the data after it that is not
    part of the reference (bs4's ``_dereference_numeric_character_reference``)."""
    base, pattern = 10, _DEC_REF
    if name[:1] in ("x", "X"):
        name, base, pattern = name[1:], 16, _HEX_REF
    try:
        return _numeric_reference(int(name, base)), ""
    except ValueError:
        m = pattern.search(name)
        if m is None:
            return "", name
        return _numeric_reference(int(m.group(1), base)), m.group(2)


class Tag:
    """An element: ``name``, ``attrs``, ``contents`` and ``parent``."""

    __slots__ = ("name", "attrs", "contents", "parent", "_kinds")

    def __init__(self, name: str, attrs: dict | None = None, parent: "Tag | None" = None):
        self.name = name
        self.attrs = attrs if attrs is not None else {}
        self.contents: list = []
        self.parent = parent
        container = STRING_CONTAINERS.get(name)
        self._kinds = (container,) if container is not None else MAIN_CONTENT

    def __repr__(self) -> str:
        return f"<{self.name} {self.attrs!r}>"

    def __bool__(self) -> bool:
        return True

    def __getitem__(self, key: str):
        return self.attrs[key]

    def get(self, key: str, default=None):
        return self.attrs.get(key, default)

    def has_attr(self, key: str) -> bool:
        return key in self.attrs

    # -- traversal --------------------------------------------------------

    @property
    def descendants(self):
        """Every node under this one, in document order."""
        stack = [iter(self.contents)]
        while stack:
            for node in stack[-1]:
                yield node
                if isinstance(node, Tag) and node.contents:
                    stack.append(iter(node.contents))
                    break
            else:
                stack.pop()

    def _tag_descendants(self):
        return (n for n in self.descendants if isinstance(n, Tag))

    # -- text -------------------------------------------------------------

    def get_text(self, separator: str = "", strip: bool = False) -> str:
        """The strings of this tag's kinds under it, joined by ``separator``;
        with ``strip``, each one stripped and the empty ones dropped."""
        kinds = self._kinds
        parts = []
        for node in self.descendants:
            if isinstance(node, str) and type(node) in kinds:
                if strip:
                    node = node.strip()
                    if not node:
                        continue
                parts.append(node)
        return separator.join(parts)

    # -- find -------------------------------------------------------------

    def find_all(self, name=None, attrs: dict | None = None, recursive: bool = True,
                 limit: int | None = None, **kwargs) -> list["Tag"]:
        """Tags under this one, in document order, whose name is ``name``
        (a string, a list of them, or ``None``/``True`` for any) and whose
        attributes pass every filter: ``True`` present, ``False`` absent, a
        string equal to the value (to one item of a list value, or to the
        whole list joined by spaces).  ``class_`` filters ``class``."""
        filters = dict(attrs or {})
        for key, value in kwargs.items():
            filters["class" if key == "class_" else key] = value
        names = None
        if isinstance(name, str):
            names = (name,)
        elif isinstance(name, (list, tuple, set, frozenset)):
            names = tuple(name)
        elif name not in (None, True):
            raise NotImplementedError(f"find_all name filter {name!r}")
        for value in filters.values():
            if not isinstance(value, (bool, str)):
                raise NotImplementedError(f"find_all attribute filter {value!r}")
        pool = self._tag_descendants() if recursive else (
            n for n in self.contents if isinstance(n, Tag))
        out = []
        for tag in pool:
            if names is not None and tag.name not in names:
                continue
            if filters and not all(_attr_filter(tag, k, v) for k, v in filters.items()):
                continue
            out.append(tag)
            if limit is not None and len(out) >= limit:
                break
        return out

    def find(self, name=None, attrs: dict | None = None, recursive: bool = True, **kwargs):
        found = self.find_all(name, attrs, recursive, limit=1, **kwargs)
        return found[0] if found else None

    # -- CSS --------------------------------------------------------------

    def select(self, selector: str, limit: int = 0) -> list["Tag"]:
        """The tags under this one that match ``selector``, in document order."""
        groups = compile_selector(selector)
        out = []
        for tag in self._tag_descendants():
            if any(_match_complex(tag, chain) for chain in groups):
                out.append(tag)
                if 0 < limit <= len(out):
                    break
        return out

    def select_one(self, selector: str):
        found = self.select(selector, limit=1)
        return found[0] if found else None


def _attr_filter(tag: Tag, key: str, want) -> bool:
    if want is True:
        return key in tag.attrs
    if want is False:
        return key not in tag.attrs
    value = tag.attrs.get(key)
    if value is None:
        return False
    if isinstance(value, list):
        return want in value or " ".join(value) == want
    return value == want


class _TreeBuilder(HTMLParser):
    """html.parser events → a :class:`Soup` tree, as bs4's html.parser
    builder and ``BeautifulSoup`` object build theirs."""

    def __init__(self, root: "Soup"):
        super().__init__(convert_charrefs=False)
        self.root = root
        self.stack: list[Tag] = [root]
        self.open_count: dict[str, int] = {}
        self.data: list[str] = []
        self.closed_void: list[str] = []
        self.preserve = 0
        self.containers: list[Tag] = []

    # -- the BeautifulSoup object's half ----------------------------------

    def end_data(self, kind=None) -> None:
        if not self.data:
            return
        text = "".join(self.data)
        self.data = []
        if not self.preserve and all(c in ASCII_SPACES for c in text):
            text = "\n" if "\n" in text else " "
        if kind is None:
            kind = (STRING_CONTAINERS[self.containers[-1].name] if self.containers
                    else NavigableString)
        node = kind(text)
        parent = self.stack[-1]
        node.parent = parent
        parent.contents.append(node)

    def push(self, tag: Tag) -> None:
        self.stack[-1].contents.append(tag)
        self.stack.append(tag)
        self.open_count[tag.name] = self.open_count.get(tag.name, 0) + 1
        if tag.name in PRESERVE_WHITESPACE:
            self.preserve += 1
        if tag.name in STRING_CONTAINERS:
            self.containers.append(tag)

    def pop(self) -> None:
        tag = self.stack.pop()
        self.open_count[tag.name] -= 1
        if tag.name in PRESERVE_WHITESPACE:
            self.preserve -= 1
        if self.containers and self.containers[-1] is tag:
            self.containers.pop()

    def pop_to(self, name: str) -> None:
        for i in range(len(self.stack) - 1, 0, -1):
            if not self.open_count.get(name):
                break
            done = self.stack[i].name == name
            self.pop()
            if done:
                break

    def start(self, name: str, attrs) -> Tag:
        self.end_data()
        values: dict = {}
        for key, value in attrs:
            values[key] = "" if value is None else value
        if values:
            for key in values.keys() & _multi_valued(name):
                values[key] = _NON_WS.findall(values[key])
        tag = Tag(name, values, self.stack[-1])
        self.push(tag)
        return tag

    def end(self, name: str) -> None:
        self.end_data()
        self.pop_to(name)

    # -- the html.parser builder's half -----------------------------------

    def handle_starttag(self, tag, attrs, void: bool = True):
        node = self.start(tag, attrs)
        if void and not node.contents and tag in VOID_ELEMENTS:
            self.end(tag)
            self.closed_void.append(tag)

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs, void=False)
        self.end(tag)

    def handle_endtag(self, tag):
        if tag in self.closed_void:
            self.closed_void.remove(tag)
        else:
            self.end(tag)

    def handle_data(self, data):
        self.data.append(data)

    def handle_charref(self, name):
        char, extra = _dereference(name)
        self.data.append(char)
        self.data.append(extra)

    def handle_entityref(self, name):
        char = ENTITIES.get(name)
        self.data.append(char if char is not None else f"&{name}")

    def _special(self, text: str, kind) -> None:
        self.end_data()
        self.data.append(text)
        self.end_data(kind)

    def handle_comment(self, data):
        self._special(data, Comment)

    def handle_decl(self, decl):
        self._special(decl[len("DOCTYPE "):], Doctype)

    def unknown_decl(self, data):
        if data.upper().startswith("CDATA["):
            self._special(data[len("CDATA["):], CData)
        else:
            self._special(data, Declaration)

    def handle_pi(self, data):
        self._special(data, ProcessingInstruction)


class Soup(Tag):
    """The document: a tag named ``[document]`` holding the parsed page.
    ``Soup(html)`` stands for ``BeautifulSoup(html, "html.parser")``."""

    __slots__ = ()

    def __init__(self, markup: str = ""):
        super().__init__(ROOT_NAME)
        if not isinstance(markup, str):
            raise TypeError(f"Soup parses str markup, not {type(markup).__name__}")
        builder = _TreeBuilder(self)
        builder.feed(markup)
        builder.close()
        builder.end_data()
        builder.closed_void.clear()


# -- CSS selectors -----------------------------------------------------------


class SelectorSyntaxError(ValueError):
    """A selector that is not valid CSS."""


# soupsieve's token patterns (``css_parser.py``), less what the subset
# leaves out: escapes, comments, namespaces, case flags and the ``~=``,
# ``|=`` and ``!=`` operators
_WS = r"[ \t\r\n\f]"
_IDENT = (r"(?:--|-?[^\x00-\x2f\x30-\x40\x5B-\x5E\x60\x7B-\x9f])"
          r"[^\x00-\x2c\x2e\x2f\x3A-\x40\x5B-\x5E\x60\x7B-\x9f]*")
_TOKEN = re.compile(
    # a run of whitespace before ``>+~,`` longer than one character reads
    # as a descendant combinator, so "div  > p" is a syntax error, as there
    rf"(?P<comb>{_WS}*?(?:[,+>~]|{_WS}(?![,+>~])){_WS}*)"
    rf"|(?P<type>\*|{_IDENT})"
    rf"|\.(?P<cls>{_IDENT})"
    rf"|#(?P<id>{_IDENT})"
    rf"|\[{_WS}*(?P<attr>{_IDENT})"
    rf"(?:{_WS}*(?P<op>[\^$*]?=){_WS}*"
    rf"(?P<value>\"[^\\\"\r\n\f]*?\"|'[^\\'\r\n\f]*?'|{_IDENT}))?{_WS}*\]")
#: what soupsieve reads and the subset does not: a pseudo-class or
#: -element, a namespace bar, an escape, a comment, or an attribute test
#: with another operator, a case flag, a namespace or escapes
_ESC = r"(?:\\(?:[a-f0-9]{1,6}[ \t\r\n\f]?|[^\r\n\f]|$))"
_IDENT_ESC = (rf"(?:(?:--|-?(?:[^\x00-\x2f\x30-\x40\x5B-\x5E\x60\x7B-\x9f]|{_ESC}))"
              rf"(?:[^\x00-\x2c\x2e\x2f\x3A-\x40\x5B-\x5E\x60\x7B-\x9f]|{_ESC})*)")
_BEYOND = re.compile(
    rf":|\||\\|/\*|\[{_WS}*(?:(?:{_IDENT_ESC}|\*)?\|)?{_IDENT_ESC}"
    rf"(?:{_WS}*[!~^|*$]?={_WS}*(?:\"(?:\\.|[^\\\"\r\n\f])*?\"|'(?:\\.|[^\\'\r\n\f])*?'"
    rf"|{_IDENT_ESC})(?:{_WS}*[is])?)?{_WS}*\]")


class _Compound:
    """One compound selector: a tag name (or ``None`` for any) with its
    classes, ids and attribute tests."""

    __slots__ = ("name", "classes", "ids", "attrs")

    def __init__(self):
        self.name: str | None = None
        self.classes: list[str] = []
        self.ids: list[str] = []
        self.attrs: list[tuple[str, re.Pattern | None]] = []

    def empty(self) -> bool:
        return self.name is None and not (self.classes or self.ids or self.attrs)


def _attr_pattern(name: str, op: str | None, raw: str | None):
    if op is None:
        return None
    value = raw[1:-1] if raw[:1] in ("'", '"') else raw
    flags = re.DOTALL | (re.I if name.lower() == "type" else 0)
    escaped = re.escape(value) if value else "(?!)"
    if op == "^=":
        return re.compile(rf"^{escaped}.*", flags)
    if op == "$=":
        return re.compile(rf".*?{escaped}$", flags)
    if op == "*=":
        return re.compile(rf".*?{escaped}.*", flags)
    return re.compile(rf"^{re.escape(value)}$", flags)


@lru_cache(maxsize=1024)
def compile_selector(selector: str) -> tuple:
    """Parse ``selector`` into comma groups of (compound, combinator)
    chains, read right to left.  Raises ``NotImplementedError`` naming a
    selector outside the subset and :class:`SelectorSyntaxError` for one
    that is not valid CSS."""
    if not isinstance(selector, str):
        raise TypeError(f"a selector is a str, not {type(selector).__name__}")
    groups: list[tuple] = []
    chain: list = []  # [compound, combinator, compound, ...]
    current = _Compound()
    pos, text = 0, selector.strip(" \t\r\n\f")

    def malformed(at: int) -> SelectorSyntaxError:
        return SelectorSyntaxError(f"malformed selector {selector!r} at {text[at:]!r}")

    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if _BEYOND.match(text, pos):
                raise NotImplementedError(
                    f"CSS selector {selector!r} is outside the supported subset (type, *, "
                    f".class, #id, [attr], [attr=v], ^=, $=, *=, the descendant, >, + and ~ "
                    f"combinators, comma groups): cannot read {text[pos:]!r}")
            raise malformed(pos)
        if m.group("comb") is not None:
            if current.empty():
                raise malformed(pos)
            chain.append(current)
            current = _Compound()
            symbol = m.group("comb").strip(" \t\r\n\f") or " "
            if symbol == ",":
                groups.append(tuple(reversed(chain)))
                chain = []
            else:
                chain.append(symbol)
        elif m.group("type") is not None:
            if not current.empty():
                raise malformed(pos)
            current.name = m.group("type").lower()
        elif m.group("cls") is not None:
            current.classes.append(m.group("cls"))
        elif m.group("id") is not None:
            current.ids.append(m.group("id"))
        else:
            name = m.group("attr")
            current.attrs.append((name.lower(), _attr_pattern(name, m.group("op"),
                                                               m.group("value"))))
        pos = m.end()
    if current.empty():  # empty, or a dangling combinator
        raise malformed(pos)
    chain.append(current)
    groups.append(tuple(reversed(chain)))
    return tuple(groups)


def _attr_value(tag: Tag, name: str):
    for key, value in tag.attrs.items():
        if key.lower() == name:
            return value
    return None


def _match_compound(tag: Tag, sel: _Compound) -> bool:
    if sel.name is not None and sel.name != "*" and sel.name != tag.name:
        return False
    for want in sel.ids:
        if _attr_value(tag, "id") != want:
            return False
    if sel.classes:
        have = _attr_value(tag, "class") or []
        if isinstance(have, str):
            have = _NON_WS.findall(have)
        if any(c not in have for c in sel.classes):
            return False
    for name, pattern in sel.attrs:
        value = _attr_value(tag, name)
        if value is None:
            return False
        if pattern is not None:
            if not isinstance(value, str):
                value = " ".join(value)
            if pattern.match(value) is None:
                return False
    return True


def _previous_tag(tag: Tag):
    parent = tag.parent
    if parent is None:
        return None
    siblings = parent.contents
    i = next(i for i, n in enumerate(siblings) if n is tag)
    for node in reversed(siblings[:i]):
        if isinstance(node, Tag):
            return node
    return None


def _match_complex(tag: Tag, chain: tuple, at: int = 0) -> bool:
    """Whether ``tag`` matches ``chain[at:]`` (right to left: a compound,
    then the combinator to its left, then the compound before it...)."""
    if not _match_compound(tag, chain[at]):
        return False
    if at + 1 >= len(chain):
        return True
    comb, rest = chain[at + 1], at + 2
    if comb == " ":
        node = tag.parent
        while node is not None:
            if _match_complex(node, chain, rest):
                return True
            node = node.parent
        return False
    if comb == ">":
        return tag.parent is not None and _match_complex(tag.parent, chain, rest)
    if comb == "+":
        prev = _previous_tag(tag)
        return prev is not None and _match_complex(prev, chain, rest)
    prev = _previous_tag(tag)
    while prev is not None:
        if _match_complex(prev, chain, rest):
            return True
        prev = _previous_tag(prev)
    return False
