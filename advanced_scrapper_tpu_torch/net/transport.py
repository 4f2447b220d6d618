"""Fetch transports — the CPU-side fetch substrate behind the engine.

The port's copy of the reference's ``net/transport.py``.

The reference drives external browser binaries over WebDriver
(geckodriver/Firefox at ``constant_rate_scrapper.py:136-139``,
undetected-chromedriver in ``experiental/00_worker.py:31``); the north star
keeps fetching CPU-side.  The engine only needs ``fetch(url) -> html``, so
transports are swappable:

- :class:`SeleniumTransport` — headless Firefox with the reference's
  preferences (images off, JS off, 30 s page-load timeout, readyState wait);
  available only where selenium + geckodriver exist.
- :class:`StealthChromeTransport` — anti-bot Chrome via
  undetected-chromedriver (the reference's experimental fleet substrate,
  ``experiental/00_worker.py:2,31-33``); explicit opt-in, never auto-picked.
- :class:`RequestsTransport` — plain HTTP with a browser UA (the substrate
  of ``ticker_symbol_query*.py``).
- :class:`MockTransport` — fixture pages for tests and offline runs.

``FetchError`` carries the error string; the engine fingerprints it for
rate-limit detection exactly like the reference fingerprints WebDriver
exceptions (``constant_rate_scrapper.py:190-193``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Mapping

USER_AGENT = (
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
    "(KHTML, like Gecko) Chrome/120.0.0.0 Safari/537.36"
)


class FetchError(Exception):
    """Fetch failure; ``str(e)`` is the error string recorded in failed CSVs."""


class MockTransport:
    """Serve canned pages.  ``pages`` maps url → html | Exception | callable;
    unknown urls raise FetchError("about:neterror")."""

    def __init__(self, pages: Mapping[str, object] | Callable[[str], str], latency: float = 0.0):
        self._pages = pages
        self._latency = latency
        self.fetched: list[str] = []

    def fetch(self, url: str) -> str:
        if self._latency:
            time.sleep(self._latency)
        self.fetched.append(url)
        if callable(self._pages):
            return self._pages(url)
        page = self._pages.get(url)
        if page is None:
            # deliberately NOT 'about:neterror': that substring is the
            # engine's rate-limit fingerprint and would trip a long global
            # pause for every missing fixture
            raise FetchError(f"no fixture for {url}")
        if isinstance(page, Exception):
            raise page
        if callable(page):
            return page(url)
        return str(page)

    def close(self) -> None:
        pass


class ChaosTransport:
    """Deliberate fault injection around any inner transport.

    The reference has **no** fault injection anywhere (SURVEY.md §5.3) —
    its failure handling is only ever exercised by real outages.  This
    wrapper makes the failure paths testable on demand: seeded, reproducible
    injection of fetch errors, rate-limit fingerprints (the
    ``about:neterror`` string the engine's circuit breaker keys on, ref
    ``constant_rate_scrapper.py:190-193``), rate-limit sentinel *pages*
    (the extractor-detected flavour, ref ``extractors/yfin.py:18-21``),
    and latency spikes.  Fault assignment is a pure function of
    ``(seed, url)`` — NOT a shared random stream — so injection is
    reproducible even when the engine fetches from many worker threads in
    nondeterministic order (a given url faults identically on every run
    and every retry with the same seed).  A url that faults is not retried
    here — failure capture, resume and the pause circuit downstream are
    exactly what is under test.
    """

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        error_rate: float = 0.0,
        neterror_rate: float = 0.0,
        rate_limit_page_rate: float = 0.0,
        latency_spike: tuple[float, float] = (0.0, 0.0),
        rate_limit_page: str | None = None,
    ):
        import threading

        self._inner = inner
        self._seed = seed
        self._error_rate = error_rate
        self._neterror_rate = neterror_rate
        self._rl_page_rate = rate_limit_page_rate
        self._spike_rate, self._spike_secs = latency_spike
        if rate_limit_page is None:
            # build the default page from the extractor's own sentinel
            # phrases so injection keeps tripping detection if they change
            from advanced_scrapper_tpu_torch.extractors.yfin import _RATE_LIMIT_NEEDLES

            rate_limit_page = (
                "<html><body>"
                + "".join(f"<p>{needle}</p>" for needle in _RATE_LIMIT_NEEDLES)
                + "</body></html>"
            )
        self._rl_page = rate_limit_page
        # engine workers share one transport: counter updates must not race
        self._count_lock = threading.Lock()
        self.injected: dict[str, int] = {
            "error": 0, "neterror": 0, "rate_limit_page": 0, "spike": 0
        }

    def _count(self, kind: str) -> None:
        with self._count_lock:
            self.injected[kind] += 1

    def fetch(self, url: str) -> str:
        import random

        # seeding Random with a string hashes its bytes (sha512) — stable
        # across processes and threads, unlike the builtin str hash
        r = random.Random(f"{self._seed}|{url}").random
        if self._spike_rate and r() < self._spike_rate:
            self._count("spike")
            time.sleep(self._spike_secs)
        if self._error_rate and r() < self._error_rate:
            self._count("error")
            raise FetchError(f"injected fault for {url}")
        if self._neterror_rate and r() < self._neterror_rate:
            self._count("neterror")
            raise FetchError(f"about:neterror (injected) for {url}")
        if self._rl_page_rate and r() < self._rl_page_rate:
            self._count("rate_limit_page")
            return self._rl_page
        return self._inner.fetch(url)

    def close(self) -> None:
        self._inner.close()


class RequestsTransport:
    def __init__(self, timeout: float = 30.0, user_agent: str = USER_AGENT):
        import requests

        self._session = requests.Session()
        self._session.headers["User-Agent"] = user_agent
        self._timeout = timeout

    def fetch(self, url: str) -> str:
        import requests

        try:
            resp = self._session.get(url, timeout=self._timeout)
        except requests.RequestException as e:
            raise FetchError(str(e)) from e
        if resp.status_code >= 400:
            raise FetchError(f"HTTP {resp.status_code} for {url}")
        return resp.text

    def close(self) -> None:
        self._session.close()


class _WebDriverTransport:
    """Shared WebDriver fetch contract: navigation + readyState wait,
    scroll-until-stable, error wrapping, quit.  Subclasses provide
    ``self._driver`` and ``self._ready_timeout`` in ``__init__``."""

    _driver = None
    _ready_timeout: float = 10.0

    def fetch(self, url: str) -> str:
        try:
            self._driver.get(url)
            # readyState poll — selenium's WebDriverWait semantics (0.5 s
            # poll, TimeoutException after the budget) implemented locally
            # so the same code drives selenium drivers AND the stdlib wire
            # client (net/webdriver.py), which has no selenium to import
            deadline = time.monotonic() + self._ready_timeout
            while (
                self._driver.execute_script("return document.readyState")
                != "complete"
            ):
                if time.monotonic() >= deadline:
                    raise FetchError(
                        f"timeout waiting for readyState complete on {url}"
                    )
                time.sleep(0.5)
            return self._driver.page_source
        except FetchError:
            raise
        except Exception as e:  # WebDriver raises many exception types
            raise FetchError(str(e)) from e

    def fetch_scrolled(
        self,
        url: str,
        *,
        max_scrolls: int = 10,
        settle_s: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> str:
        """Fetch, then scroll to the bottom until the page height stabilises
        (lazy-loaded feeds; ref ``experiental/04_crypto_1.py:57-63``).

        ``max_scrolls`` bounds infinite feeds; ``settle_s`` is the ref's
        post-scroll wait for the lazy loader to append content.
        """
        self.fetch(url)  # navigation + readyState wait
        try:
            last_height = self._driver.execute_script(
                "return document.body.scrollHeight"
            )
            for _ in range(max_scrolls):
                self._driver.execute_script(
                    "window.scrollTo(0, document.body.scrollHeight);"
                )
                sleep(settle_s)
                height = self._driver.execute_script(
                    "return document.body.scrollHeight"
                )
                if height == last_height:
                    break  # stable: nothing more is lazy-loading
                last_height = height
            return self._driver.page_source
        except Exception as e:
            raise FetchError(str(e)) from e

    def close(self) -> None:
        self._driver.quit()


class SeleniumTransport(_WebDriverTransport):
    """Headless Firefox via geckodriver, reference preferences
    (``constant_rate_scrapper.py:33-41,136-153``)."""

    def __init__(
        self,
        page_load_timeout: float = 30.0,
        ready_state_timeout: float = 10.0,
        executable_path: str = "geckodriver",
    ):
        from selenium import webdriver
        from selenium.webdriver.firefox.options import Options
        from selenium.webdriver.firefox.service import Service

        options = Options()
        options.set_preference("permissions.default.image", 2)
        options.set_preference("javascript.enabled", False)
        options.set_preference("dom.ipc.plugins.enabled.libflashplayer.so", False)
        options.add_argument("-headless")
        self._driver = webdriver.Firefox(
            service=Service(executable_path=executable_path), options=options
        )
        self._driver.set_page_load_timeout(page_load_timeout)
        self._ready_timeout = ready_state_timeout


class StealthChromeTransport(_WebDriverTransport):
    """Anti-bot Chrome via undetected-chromedriver — the reference's
    experimental fleet substrate (``experiental/00_worker.py:2,31-33``,
    ``03_worker_multi.py:64``), which patches Chrome to evade
    navigator.webdriver/CDP fingerprinting where stock Firefox is blocked.

    Same ``fetch()`` contract as every other transport, so engines and
    pools are substrate-agnostic; select with
    ``ScraperConfig.transport = "stealth-chrome"``.  The import is lazy and
    optional — without the package this raises ImportError at construction
    (``make_transport("auto")`` never picks it implicitly; anti-bot
    crawling should be an explicit operator choice).
    """

    #: uc.Chrome() runs a binary patcher over a shared cached chromedriver;
    #: concurrent instantiation (engine workers each build their transport)
    #: can collide in the patcher — construction is serialized process-wide.
    _construct_lock = threading.Lock()

    def __init__(
        self,
        page_load_timeout: float = 30.0,
        ready_state_timeout: float = 10.0,
        headless: bool = True,
        options=None,
    ):
        import undetected_chromedriver as uc

        if options is None:
            options = uc.ChromeOptions()
            if headless:
                options.add_argument("--headless=new")
        with StealthChromeTransport._construct_lock:
            self._driver = uc.Chrome(options=options)
        self._driver.set_page_load_timeout(page_load_timeout)
        self._ready_timeout = ready_state_timeout


class WireFirefoxTransport(_WebDriverTransport):
    """Headless Firefox via geckodriver over the FIRST-PARTY WebDriver wire
    client (``net/webdriver.py``) — no selenium package needed.  Same
    reference preferences and fetch contract as :class:`SeleniumTransport`;
    ``remote_url`` attaches to an already-running driver (or grid/test
    endpoint) instead of spawning geckodriver."""

    def __init__(
        self,
        page_load_timeout: float = 30.0,
        ready_state_timeout: float = 10.0,
        executable_path: str = "geckodriver",
        remote_url: str | None = None,
    ):
        from advanced_scrapper_tpu_torch.net.webdriver import WireFirefoxDriver

        self._driver = WireFirefoxDriver(
            executable_path, remote_url=remote_url
        )
        self._driver.set_page_load_timeout(page_load_timeout)
        self._ready_timeout = ready_state_timeout


class WireChromeTransport(_WebDriverTransport):
    """Headless plain Chrome via chromedriver over the wire client —
    explicit opt-in (``--transport chrome-wire``), like every Chrome
    substrate here; for anti-bot crawling use stealth-chrome instead."""

    def __init__(
        self,
        page_load_timeout: float = 30.0,
        ready_state_timeout: float = 10.0,
        executable_path: str = "chromedriver",
        remote_url: str | None = None,
    ):
        from advanced_scrapper_tpu_torch.net.webdriver import WireChromeDriver

        self._driver = WireChromeDriver(
            executable_path, remote_url=remote_url
        )
        self._driver.set_page_load_timeout(page_load_timeout)
        self._ready_timeout = ready_state_timeout


def stealth_chrome_available() -> bool:
    """True when the undetected-chromedriver package is importable."""
    try:
        import undetected_chromedriver  # noqa: F401
    except ImportError:
        return False
    return True


def _resolve_binary(name: str) -> str | None:
    """PATH hit, else a cwd-relative file made absolute (the reference
    ships geckodriver next to the scripts, ``.MISSING_LARGE_BLOBS:1-2``)
    — ``Popen`` resolves bare names through PATH only, so a cwd hit must
    be returned as an absolute path for the spawn to agree with us."""
    import shutil

    hit = shutil.which(name)
    if hit is not None:
        return hit
    if os.path.isfile(name) and os.access(name, os.X_OK):
        return os.path.abspath(name)
    return None


def selenium_available() -> bool:
    """True only when the whole stack exists: the selenium package AND a
    geckodriver binary (the external WebDriver shim the reference ships,
    ``.MISSING_LARGE_BLOBS:1-2``)."""
    try:
        import selenium  # noqa: F401
    except ImportError:
        return False
    return _resolve_binary("geckodriver") is not None


def geckodriver_available() -> bool:
    """True when a geckodriver binary exists — all the wire transport
    needs (the selenium package is optional with ``net/webdriver.py``)."""
    return _resolve_binary("geckodriver") is not None


def make_transport(
    name: str = "auto",
    *,
    page_load_timeout: float = 30.0,
    ready_state_timeout: float = 10.0,
    pages=None,
    **kw,
):
    """``auto`` prefers browser fidelity and falls back to HTTP: selenium
    if the package is installed, else the first-party wire client if a
    geckodriver binary exists, else plain requests.

    Timeouts map onto whichever transport is chosen: browser transports get
    both, requests uses ``page_load_timeout`` as its request timeout.
    """
    if name == "auto":
        if selenium_available():
            try:
                return SeleniumTransport(
                    page_load_timeout=page_load_timeout,
                    ready_state_timeout=ready_state_timeout,
                    **kw,
                )
            except Exception:
                pass  # broken browser stack → HTTP fallback, as documented
        # fall-through, not elif: a selenium install that imports but fails
        # to construct must still try the wire client before degrading to
        # plain HTTP — the geckodriver binary is all the wire path needs
        gecko = _resolve_binary("geckodriver")
        if gecko is not None:
            try:
                return WireFirefoxTransport(
                    page_load_timeout=page_load_timeout,
                    ready_state_timeout=ready_state_timeout,
                    **{"executable_path": gecko, **kw},
                )
            except Exception:
                pass
        name = "requests"
    if name == "selenium":
        return SeleniumTransport(
            page_load_timeout=page_load_timeout,
            ready_state_timeout=ready_state_timeout,
            **kw,
        )
    if name == "firefox-wire":
        return WireFirefoxTransport(
            page_load_timeout=page_load_timeout,
            ready_state_timeout=ready_state_timeout,
            **kw,
        )
    if name == "chrome-wire":
        return WireChromeTransport(
            page_load_timeout=page_load_timeout,
            ready_state_timeout=ready_state_timeout,
            **kw,
        )
    if name == "stealth-chrome":
        return StealthChromeTransport(
            page_load_timeout=page_load_timeout,
            ready_state_timeout=ready_state_timeout,
            **kw,
        )
    if name == "requests":
        return RequestsTransport(timeout=page_load_timeout)
    if name == "mock":
        return MockTransport(pages if pages is not None else {})
    raise ValueError(f"unknown transport '{name}'")
