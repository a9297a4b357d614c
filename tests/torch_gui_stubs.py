"""Display stand-ins for driving the port's GUI without a display toolkit.

``install_qt`` puts the functional PyQt6 stand-ins of ``tests/qt_stub.py``
into ``sys.modules`` (when PyQt6 is absent) and purges the port's GUI
modules, so they import against the stand-ins; ``purge`` removes them
again, so a module imported against one set of stand-ins never leaks into
a later test on the same worker.

``install_matplotlib`` does the same for matplotlib, which the port's
panels, advanced panels and circuit renderer import: a recording
stand-in for the few names they use (``matplotlib.use``,
``matplotlib.figure.Figure``, ``matplotlib.pyplot.subplots`` /
``figure`` / ``close``, ``matplotlib.patches.Circle`` /
``FancyBboxPatch``). Every drawing call is accepted and recorded, a
``set_<x>`` call is read back by ``get_<x>``, and nothing is drawn. It
stands in for a display toolkit only: the engine calls behind the panels
run as they would. The card's GUI tests (``tests/test_torch_gpu.py``)
use both on a machine that lacks the toolkits; the CPU tests draw with the
real matplotlib.
"""

from __future__ import annotations

import sys
import types

from tests import qt_stub

PORT_GUI = "quantum_simulator_tpu_torch.gui"
PORT_RENDER = "quantum_simulator_tpu_torch.render"


def purge(*prefixes: str) -> None:
    """Drop every imported module under the port's GUI (and ``prefixes``)
    from ``sys.modules``."""
    for name in list(sys.modules):
        if name.startswith((PORT_GUI,) + prefixes):
            del sys.modules[name]


def install_qt(monkeypatch) -> bool:
    """The PyQt6 stand-ins (monkeypatch-scoped), the port's GUI purged;
    False, and nothing installed, where real PyQt6 exists."""
    purge()
    return qt_stub.install(monkeypatch)


class Artist:
    """Accepts any attribute and any call. A call of a child named
    ``set_<x>`` stores its first argument under ``x`` on the parent,
    ``get_<x>`` reads it back (``""`` when unset); every call is appended
    to the parent's ``calls``."""

    def __init__(self, *args, _name: str = "artist", _parent=None, **kwargs):
        self._name = _name
        self._parent = _parent
        self.calls: list[tuple] = []
        self.props: dict = {}

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        child = Artist(_name=name, _parent=self)
        self.__dict__[name] = child
        return child

    def __call__(self, *args, **kwargs):
        parent = self._parent
        if parent is not None:
            parent.calls.append((self._name, args, kwargs))
            if self._name.startswith("set_"):
                parent.props[self._name[4:]] = args[0] if args else kwargs
            elif self._name.startswith("get_"):
                return parent.props.get(self._name[4:], "")
        return Artist(_name=f"{self._name}()")


class Figure(Artist):
    """``matplotlib.figure.Figure``: its axes are ``Artist`` objects."""

    def __init__(self, *args, **kwargs):
        super().__init__(_name="figure")
        self.axes: list[Artist] = []

    def clear(self) -> None:
        self.axes = []

    def add_subplot(self, *args, **kwargs) -> Artist:
        ax = Artist(_name="axes")
        self.axes.append(ax)
        return ax

    def gca(self) -> Artist:
        return self.axes[-1] if self.axes else self.add_subplot()


def _subplots(*args, **kwargs):
    fig = Figure()
    return fig, fig.add_subplot()


def install_matplotlib(monkeypatch, force: bool = False) -> bool:
    """The recording matplotlib stand-in (monkeypatch-scoped), the port's
    GUI and renderer purged; False, and nothing installed, where
    matplotlib imports, unless ``force``."""
    if not force:
        try:
            import matplotlib  # noqa: F401

            return False
        except ImportError:
            pass
    purge(PORT_RENDER)
    mpl = types.ModuleType("matplotlib")
    mpl.__path__ = []
    mpl.__version__ = "stand-in"
    mpl.use = lambda *a, **k: None
    figure = types.ModuleType("matplotlib.figure")
    figure.Figure = Figure
    pyplot = types.ModuleType("matplotlib.pyplot")
    pyplot.subplots = _subplots
    pyplot.figure = Figure
    pyplot.close = lambda *a, **k: None
    patches = types.ModuleType("matplotlib.patches")
    patches.Circle = patches.FancyBboxPatch = Artist
    backends = types.ModuleType("matplotlib.backends")
    backends.__path__ = []
    mpl.figure, mpl.pyplot, mpl.patches = figure, pyplot, patches
    mpl.backends = backends
    modules = {"matplotlib": mpl, "matplotlib.figure": figure,
               "matplotlib.pyplot": pyplot, "matplotlib.patches": patches,
               "matplotlib.backends": backends}
    if "matplotlib.backends.backend_qtagg" not in sys.modules:
        qtagg = types.ModuleType("matplotlib.backends.backend_qtagg")
        qtagg.FigureCanvasQTAgg = qt_stub.FigureCanvasQTAgg
        modules["matplotlib.backends.backend_qtagg"] = qtagg
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return True
