"""Theme loading: dark (Catppuccin Mocha) / light (Latte) QSS stylesheets.

A copy of ``quantum_simulator_tpu/gui/themes/theme_manager.py``: it reads
the ``.qss`` files beside it.
"""

from __future__ import annotations

from pathlib import Path

_THEME_DIR = Path(__file__).parent


class ThemeManager:
    """Loads QSS stylesheets and applies them to a QApplication."""

    THEMES = ("dark", "light")

    def __init__(self, theme: str = "dark"):
        self._theme = theme if theme in self.THEMES else "dark"

    @property
    def theme(self) -> str:
        return self._theme

    def stylesheet(self, theme: str | None = None) -> str:
        name = theme or self._theme
        path = _THEME_DIR / f"{name}.qss"
        if path.exists():
            return path.read_text(encoding="utf-8")
        return ""

    def apply(self, app, theme: str | None = None) -> None:
        if theme is not None:
            self._theme = theme
        app.setStyleSheet(self.stylesheet())

    def toggle(self, app) -> str:
        self._theme = "light" if self._theme == "dark" else "dark"
        self.apply(app)
        return self._theme
