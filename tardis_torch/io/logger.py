"""Logging subsystem.

Counterpart of the reference's ``TARDISLogger`` stack
(tardis/io/logger/logger.py:18-260 and colored_logger.py):
configurable log level, optional *specific*-level filtering (show ONLY the
requested level rather than level-and-above), colored console output, and
the ``debug/log_level`` config wiring used by ``run_tardis``.

``JupyterLogWidgetHandler`` (below) reproduces the reference's Jupyter
widget log panel (per-level tab columns with batched flushing) when
ipywidgets is available; the colored stream handler is the terminal path.
The port's copy of ``tardis_tpu/io/logger.py``; it configures the
``tardis_torch`` logger tree, and IPython / ipywidgets are imported only
where a notebook panel is asked for.
"""

from __future__ import annotations

import logging
import logging.handlers
import sys

LOG_LEVELS = ("NOTSET", "DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")
DEFAULT_LOG_LEVEL = "INFO"

_COLORS = {
    logging.DEBUG: "\x1b[36m",  # cyan
    logging.INFO: "\x1b[32m",  # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[1;31m",  # bold red
}
_RESET = "\x1b[0m"


class ColoredFormatter(logging.Formatter):
    """Level-colored console formatter (reference colored_logger.py)."""

    def __init__(self, use_color: bool | None = None):
        super().__init__(
            "[%(name)s][%(levelname)s%(reset)s ] %(message)s "
            "(%(filename)s:%(lineno)d)"
        )
        if use_color is None:
            use_color = sys.stderr.isatty()
        self.use_color = use_color

    def format(self, record):
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            record.levelname = f"{color}{record.levelname}"
            record.reset = _RESET
        else:
            record.reset = ""
        return super().format(record)


class LogFilter(logging.Filter):
    """Keep only records whose level is in ``log_levels``
    (reference io/logger/logger.py LogFilter)."""

    def __init__(self, log_levels):
        super().__init__()
        self.log_levels = log_levels

    def filter(self, record):
        return record.levelno in self.log_levels


def _in_notebook() -> bool:
    """True inside a Jupyter kernel (reference util/environment.py)."""
    try:
        from IPython import get_ipython

        shell = get_ipython()
        return (
            shell is not None
            and shell.__class__.__name__ == "ZMQInteractiveShell"
        )
    except Exception:
        return False


class JupyterLogWidgetHandler(logging.Handler):
    """Per-level scrolling log columns rendered as ipywidgets HTML
    (reference io/logger/logger.py:55-226 widget panel: one column per
    level, batched async updates).  Records are buffered and flushed to
    the widgets every ``batch_size`` records (and on ERROR+)."""

    _CSS_COLORS = {
        logging.DEBUG: "#2aa4b0",
        logging.INFO: "#2e8b57",
        logging.WARNING: "#b8860b",
        logging.ERROR: "#c0392b",
        logging.CRITICAL: "#c0392b",
    }

    def __init__(self, batch_size: int = 10, max_rows: int = 500):
        super().__init__()
        import ipywidgets as w

        self.batch_size = max(int(batch_size), 1)
        self.max_rows = max_rows
        self._rows: dict[str, list] = {}
        self._pending = 0
        self._columns = {}
        tabs = []
        self._names = ("INFO", "WARNING/ERROR", "DEBUG", "ALL")
        for name in self._names:
            self._rows[name] = []
            self._columns[name] = w.HTML("")
            tabs.append(self._columns[name])
        self.widget = w.Tab(children=tabs)
        for i, name in enumerate(self._names):
            self.widget.set_title(i, name)

    def _column_for(self, levelno: int) -> str:
        if levelno >= logging.WARNING:
            return "WARNING/ERROR"
        if levelno == logging.DEBUG:
            return "DEBUG"
        return "INFO"

    def emit(self, record):
        color = self._CSS_COLORS.get(record.levelno, "#000")
        html = (
            f'<code><span style="color:{color}">'
            f"[{record.levelname}]</span> "
            f"{logging.Handler.format(self, record)}</code><br>"
        )
        for name in (self._column_for(record.levelno), "ALL"):
            rows = self._rows[name]
            rows.append(html)
            del rows[: -self.max_rows]
        self._pending += 1
        if (
            self._pending >= self.batch_size
            or record.levelno >= logging.ERROR
        ):
            self.flush()

    def flush(self):
        for name, rows in self._rows.items():
            self._columns[name].value = (
                '<div style="max-height:300px;overflow-y:auto">'
                + "".join(rows)
                + "</div>"
            )
        self._pending = 0

    def display(self):
        from IPython.display import display

        display(self.widget)


class TARDISLogger:
    """Configures the 'tardis_torch' logger tree
    (reference io/logger/logger.py:55-226, including the Jupyter widget
    panel when running in a notebook)."""

    def __init__(self, name: str = "tardis_torch"):
        self.logger = logging.getLogger(name)
        self._handler = None
        self._widget_handler = None

    def configure_logging(
        self, log_level: str, config=None, specific_log_level: bool = False,
        display_widget: bool | None = None,
    ):
        # config debug section wins over the argument (reference behavior:
        # logging_state resolves debug.log_level vs the function arg)
        buffer_capacity = 1
        if config is not None:
            debug = (
                config.get("debug", {}) if hasattr(config, "get") else {}
            )
            cfg_level = (debug or {}).get("log_level")
            if cfg_level and not log_level:
                log_level = cfg_level
            if (debug or {}).get("specific_log_level") is not None:
                specific_log_level = bool(debug["specific_log_level"])
            # montecarlo.logger_buffer: records per flush (reference
            # io/logger/logger.py async widget-handler buffering; here a
            # MemoryHandler in front of the console stream)
            mc = config.get("montecarlo", {}) if hasattr(
                config, "get"
            ) else {}
            buffer_capacity = int((mc or {}).get("logger_buffer", 1))
        log_level = (log_level or DEFAULT_LOG_LEVEL).upper()
        if log_level not in LOG_LEVELS:
            raise ValueError(
                f"log_level must be one of {LOG_LEVELS}, got {log_level!r}"
            )
        numeric = getattr(logging, log_level) if log_level != "NOTSET" else 0

        root = self.logger
        if self._handler is not None:
            root.removeHandler(self._handler)
        handler = logging.StreamHandler()
        handler.setFormatter(ColoredFormatter())
        if buffer_capacity > 1:
            handler = logging.handlers.MemoryHandler(
                capacity=buffer_capacity,
                flushLevel=logging.ERROR,
                target=handler,
            )
        root.addHandler(handler)
        root.setLevel(numeric if numeric else logging.NOTSET)
        root.propagate = False
        self._handler = handler

        for f in list(handler.filters):
            handler.removeFilter(f)
        if specific_log_level and numeric:
            handler.addFilter(LogFilter([numeric]))

        # Jupyter widget panel (reference per-level log columns): auto on
        # inside a notebook kernel, forced with display_widget=True
        if display_widget is None:
            display_widget = _in_notebook()
        if self._widget_handler is not None:
            root.removeHandler(self._widget_handler)
            self._widget_handler = None
        if display_widget:
            wh = JupyterLogWidgetHandler(
                batch_size=max(buffer_capacity, 1)
            )
            wh.setFormatter(logging.Formatter("%(message)s"))
            if specific_log_level and numeric:
                wh.addFilter(LogFilter([numeric]))
            root.addHandler(wh)
            self._widget_handler = wh
            if _in_notebook():
                wh.display()
        return self


def logging_asked(log_level: str | None, config=None,
                  specific_log_level: bool = False) -> bool:
    """Whether the arguments or the config ask for logging: a
    ``log_level``, ``specific_log_level``, a ``debug`` section with either,
    or a ``montecarlo.logger_buffer`` above 1."""
    if log_level or specific_log_level:
        return True
    if config is None or not hasattr(config, "get"):
        return False
    debug = config.get("debug", {}) or {}
    mc = config.get("montecarlo", {}) or {}
    return bool(debug.get("log_level") or debug.get("specific_log_level")
                or int(mc.get("logger_buffer", 1)) > 1)


def logging_state(log_level: str | None, config=None,
                  specific_log_level: bool = False) -> TARDISLogger:
    """Configure framework logging (reference io/logger/logger.py:228-260)."""
    tl = TARDISLogger()
    tl.configure_logging(log_level or "", config, specific_log_level)
    return tl
