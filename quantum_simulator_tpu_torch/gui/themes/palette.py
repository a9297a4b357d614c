"""Palette-driven QSS generation.

Both shipped themes (dark = Catppuccin Mocha hues, light = Latte hues)
are generated from one widget-coverage template, so every widget class
the app uses is styled consistently in both and adding a widget style is
a one-place change. A copy of
``quantum_simulator_tpu/gui/themes/palette.py`` (no engine, no device).
Regenerate the checked-in ``.qss`` files with:

    python -m quantum_simulator_tpu_torch.gui.themes.palette
"""

from __future__ import annotations

from pathlib import Path

DARK = {
    "base": "#1e1e2e", "mantle": "#181825", "crust": "#11111b",
    "surface0": "#313244", "surface1": "#45475a", "surface2": "#585b70",
    "overlay": "#6c7086", "text": "#cdd6f4", "subtext": "#a6adc8",
    "accent": "#89b4fa", "accent_dim": "#74a0e8", "green": "#a6e3a1",
    "red": "#f38ba8", "peach": "#fab387", "yellow": "#f9e2af",
    "sel_text": "#11111b",
}

LIGHT = {
    "base": "#eff1f5", "mantle": "#e6e9ef", "crust": "#dce0e8",
    "surface0": "#ccd0da", "surface1": "#bcc0cc", "surface2": "#acb0be",
    "overlay": "#7c7f93", "text": "#4c4f69", "subtext": "#5c5f77",
    "accent": "#1e66f5", "accent_dim": "#4a82f7", "green": "#40a02b",
    "red": "#d20f39", "peach": "#fe640b", "yellow": "#df8e1d",
    "sel_text": "#eff1f5",
}

_TEMPLATE = """\
/* {title} — generated by themes/palette.py; edit the palette, not this
   file. */

/* ---- base ------------------------------------------------------------ */
QWidget {{
    background-color: {base};
    color: {text};
    font-size: 12px;
    selection-background-color: {accent};
    selection-color: {sel_text};
}}
QMainWindow, QDialog {{
    background-color: {mantle};
}}
QLabel {{
    background: transparent;
}}
QToolTip {{
    background-color: {crust};
    color: {text};
    border: 1px solid {surface1};
    padding: 4px;
}}

/* ---- menus / toolbars / status --------------------------------------- */
QMenuBar {{
    background-color: {mantle};
    color: {text};
}}
QMenuBar::item {{
    padding: 4px 10px;
    background: transparent;
}}
QMenuBar::item:selected {{
    background-color: {surface0};
    border-radius: 4px;
}}
QMenu {{
    background-color: {base};
    border: 1px solid {surface0};
    padding: 4px;
}}
QMenu::item {{
    padding: 5px 24px 5px 12px;
    border-radius: 4px;
}}
QMenu::item:selected {{
    background-color: {surface0};
}}
QMenu::item:disabled {{
    color: {overlay};
}}
QMenu::separator {{
    height: 1px;
    background: {surface0};
    margin: 4px 8px;
}}
QToolBar {{
    background-color: {mantle};
    border-bottom: 1px solid {surface0};
    spacing: 4px;
}}
QStatusBar {{
    background-color: {mantle};
    color: {subtext};
    border-top: 1px solid {surface0};
}}

/* ---- buttons ---------------------------------------------------------- */
QPushButton {{
    background-color: {surface0};
    border: 1px solid {surface1};
    border-radius: 4px;
    padding: 5px 12px;
}}
QPushButton:hover {{
    background-color: {surface1};
    border-color: {surface2};
}}
QPushButton:pressed {{
    background-color: {surface2};
}}
QPushButton:checked {{
    background-color: {accent};
    color: {sel_text};
}}
QPushButton:disabled {{
    color: {overlay};
    border-color: {surface0};
}}
QPushButton:default {{
    border: 1px solid {accent};
}}
QToolButton {{
    background: transparent;
    border: none;
    border-radius: 4px;
    padding: 4px;
}}
QToolButton:hover {{
    background-color: {surface0};
}}
QToolButton:checked {{
    background-color: {surface1};
}}

/* ---- inputs ------------------------------------------------------------ */
QLineEdit, QTextEdit, QPlainTextEdit, QSpinBox, QDoubleSpinBox,
QComboBox {{
    background-color: {crust};
    border: 1px solid {surface1};
    border-radius: 4px;
    padding: 3px 6px;
}}
QLineEdit:focus, QTextEdit:focus, QPlainTextEdit:focus, QSpinBox:focus,
QDoubleSpinBox:focus, QComboBox:focus {{
    border-color: {accent};
}}
QLineEdit:disabled, QSpinBox:disabled, QDoubleSpinBox:disabled,
QComboBox:disabled {{
    color: {overlay};
    background-color: {mantle};
}}
QSpinBox::up-button, QDoubleSpinBox::up-button,
QSpinBox::down-button, QDoubleSpinBox::down-button {{
    background-color: {surface0};
    width: 16px;
    border: none;
}}
QSpinBox::up-button:hover, QDoubleSpinBox::up-button:hover,
QSpinBox::down-button:hover, QDoubleSpinBox::down-button:hover {{
    background-color: {surface1};
}}
QComboBox::drop-down {{
    border: none;
    width: 18px;
}}
QComboBox QAbstractItemView {{
    background-color: {base};
    border: 1px solid {surface1};
    selection-background-color: {surface0};
    selection-color: {text};
}}
QCheckBox, QRadioButton {{
    spacing: 6px;
    background: transparent;
}}
QCheckBox::indicator, QRadioButton::indicator {{
    width: 15px;
    height: 15px;
    border: 1px solid {surface2};
    border-radius: 3px;
    background-color: {crust};
}}
QRadioButton::indicator {{
    border-radius: 7px;
}}
QCheckBox::indicator:checked, QRadioButton::indicator:checked {{
    background-color: {accent};
    border-color: {accent_dim};
}}
QCheckBox::indicator:disabled, QRadioButton::indicator:disabled {{
    border-color: {surface0};
}}

/* ---- sliders / progress ------------------------------------------------- */
QSlider::groove:horizontal {{
    height: 5px;
    background: {surface0};
    border-radius: 2px;
}}
QSlider::handle:horizontal {{
    width: 14px;
    margin: -5px 0;
    border-radius: 7px;
    background: {accent};
}}
QSlider::handle:horizontal:hover {{
    background: {accent_dim};
}}
QSlider::sub-page:horizontal {{
    background: {accent_dim};
    border-radius: 2px;
}}
QProgressBar {{
    background-color: {surface0};
    border: none;
    border-radius: 4px;
    text-align: center;
    color: {text};
    height: 14px;
}}
QProgressBar::chunk {{
    background-color: {green};
    border-radius: 4px;
}}

/* ---- containers ----------------------------------------------------------- */
QGroupBox {{
    border: 1px solid {surface0};
    border-radius: 6px;
    margin-top: 12px;
    padding-top: 8px;
}}
QGroupBox::title {{
    subcontrol-origin: margin;
    left: 10px;
    padding: 0 4px;
    color: {subtext};
}}
QTabWidget::pane {{
    border: 1px solid {surface0};
    border-radius: 4px;
    top: -1px;
}}
QTabBar::tab {{
    background-color: {mantle};
    color: {subtext};
    padding: 6px 14px;
    border: 1px solid {surface0};
    border-bottom: none;
    border-top-left-radius: 4px;
    border-top-right-radius: 4px;
}}
QTabBar::tab:selected {{
    background-color: {base};
    color: {text};
    border-bottom: 2px solid {accent};
}}
QTabBar::tab:hover:!selected {{
    background-color: {surface0};
}}
QDockWidget {{
    titlebar-close-icon: none;
}}
QDockWidget::title {{
    background-color: {mantle};
    padding: 5px;
    border-bottom: 1px solid {surface0};
}}
QSplitter::handle {{
    background-color: {surface0};
}}
QSplitter::handle:hover {{
    background-color: {accent_dim};
}}
QToolBox::tab {{
    background-color: {surface0};
    border-radius: 4px;
    padding: 4px;
    color: {text};
}}
QToolBox::tab:selected {{
    background-color: {surface1};
    font-weight: bold;
}}
QFrame[frameShape="4"], QFrame[frameShape="5"] {{
    color: {surface0};
}}

/* ---- item views --------------------------------------------------------------- */
QTableWidget, QTableView, QListWidget, QListView, QTreeWidget,
QTreeView {{
    background-color: {crust};
    alternate-background-color: {mantle};
    border: 1px solid {surface0};
    gridline-color: {surface0};
}}
QHeaderView::section {{
    background-color: {mantle};
    color: {subtext};
    border: none;
    border-right: 1px solid {surface0};
    border-bottom: 1px solid {surface0};
    padding: 4px 8px;
}}
QTableCornerButton::section {{
    background-color: {mantle};
    border: none;
}}
QTableWidget::item:selected, QListWidget::item:selected,
QTreeWidget::item:selected {{
    background-color: {accent};
    color: {sel_text};
}}

/* ---- scrollbars ------------------------------------------------------------------ */
QScrollBar:vertical {{
    background: {mantle};
    width: 10px;
    margin: 0;
}}
QScrollBar::handle:vertical {{
    background: {surface1};
    border-radius: 5px;
    min-height: 24px;
}}
QScrollBar::handle:vertical:hover {{
    background: {surface2};
}}
QScrollBar:horizontal {{
    background: {mantle};
    height: 10px;
    margin: 0;
}}
QScrollBar::handle:horizontal {{
    background: {surface1};
    border-radius: 5px;
    min-width: 24px;
}}
QScrollBar::handle:horizontal:hover {{
    background: {surface2};
}}
QScrollBar::add-line, QScrollBar::sub-line {{
    width: 0;
    height: 0;
}}
QScrollBar::add-page, QScrollBar::sub-page {{
    background: none;
}}

/* ---- graphics view (circuit editor) ----------------------------------------------- */
QGraphicsView {{
    background-color: {crust};
    border: 1px solid {surface0};
    border-radius: 4px;
}}

/* ---- message boxes / misc ----------------------------------------------------------- */
QMessageBox {{
    background-color: {base};
}}
QTextBrowser {{
    background-color: {crust};
    border: 1px solid {surface0};
    border-radius: 4px;
}}
QDialogButtonBox QPushButton {{
    min-width: 72px;
}}
"""


def build_qss(palette: dict, title: str) -> str:
    return _TEMPLATE.format(title=title, **palette)


def write_themes(directory: Path | None = None) -> None:
    directory = directory or Path(__file__).parent
    (directory / "dark.qss").write_text(
        build_qss(DARK, "Dark theme — Catppuccin Mocha hues"),
        encoding="utf-8")
    (directory / "light.qss").write_text(
        build_qss(LIGHT, "Light theme — Catppuccin Latte hues"),
        encoding="utf-8")


if __name__ == "__main__":
    write_themes()
    print("wrote dark.qss / light.qss")
