"""The PyQt5 desktop application (view layer).

Counterpart of the JAX package's ``gui/app.py``: a main window with a
toolbar, degradation / enhancement / advanced settings tabs, a zoomable
image viewer with its comparison modes, a colored log console, the
model-download action, and background enhancement with live progress and
intermediate images.

All logic lives in ``gui/controller.py`` (tested without a display); this
module binds it to widgets and imports PyQt5 behind a guard, so that a
machine without Qt keeps the CLI and the API (``HAS_QT`` is False there
and ``NESRApplication`` raises ImportError).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from neural_enhanced_super_resolution_torch.gui.controller import (
    DegradationState, EnhancementSettingsState, EnhancementWorker,
    ModelDownloadWorker, PRESETS, check_model_status)

logger = logging.getLogger("nesr.gui")

try:  # pragma: no cover - exercised only where Qt is installed
    from PyQt5.QtCore import Qt, pyqtSignal, QObject
    from PyQt5.QtGui import QImage, QPixmap
    from PyQt5.QtWidgets import (
        QApplication, QMainWindow, QWidget, QLabel, QPushButton, QVBoxLayout,
        QHBoxLayout, QTabWidget, QFileDialog, QComboBox, QSpinBox,
        QDoubleSpinBox, QCheckBox, QTextEdit, QProgressBar, QSlider,
        QScrollArea, QMessageBox, QGroupBox, QFormLayout, QLineEdit, QAction)
    HAS_QT = True
except ImportError:  # pragma: no cover
    HAS_QT = False

__all__ = ["NESRApplication", "run_gui", "HAS_QT"]


if HAS_QT:  # pragma: no cover - Qt widgets need a display to exercise

    def _np_to_pixmap(img: np.ndarray) -> "QPixmap":
        img = np.ascontiguousarray(img)
        h, w = img.shape[:2]
        qimg = QImage(img.data, w, h, 3 * w, QImage.Format_RGB888)
        return QPixmap.fromImage(qimg.copy())

    class _WorkerBridge(QObject):
        """Marshals worker-thread events onto the GUI thread.

        EnhancementWorker runs on a plain thread and invokes callbacks
        directly; Qt widgets are not thread-safe, so the app hands the worker
        these signals' ``emit`` methods and connects the signals (queued to
        the main thread by Qt) to the widget-mutating slots — the same
        pattern as a pyqtSignal worker."""
        progress = pyqtSignal(str, int, int, str)
        image = pyqtSignal(object)
        finished = pyqtSignal(str)
        error = pyqtSignal(str)
        dl_progress = pyqtSignal(float)
        dl_finished = pyqtSignal(object)

    class _LogBridge(QObject, logging.Handler):
        """logging.Handler -> Qt signal."""
        message = pyqtSignal(str, str)

        def __init__(self):
            QObject.__init__(self)
            logging.Handler.__init__(self)

        def emit(self, record):
            self.message.emit(record.levelname, self.format(record))

    class LogConsole(QWidget):
        """Colored HTML log view with save/clear."""

        COLORS = {"DEBUG": "#888", "INFO": "#ddd", "WARNING": "#fa0",
                  "ERROR": "#f44", "CRITICAL": "#f0f"}

        def __init__(self):
            super().__init__()
            self.view = QTextEdit(readOnly=True)
            save = QPushButton("Save Log")
            clear = QPushButton("Clear")
            save.clicked.connect(self._save)
            clear.clicked.connect(self.view.clear)
            row = QHBoxLayout()
            row.addWidget(save)
            row.addWidget(clear)
            lay = QVBoxLayout(self)
            lay.addWidget(self.view)
            lay.addLayout(row)
            self.bridge = _LogBridge()
            self.bridge.setFormatter(logging.Formatter(
                "%(asctime)s - %(name)s - %(message)s"))
            self.bridge.message.connect(self._append)
            logging.getLogger("nesr").addHandler(self.bridge)

        def _append(self, level, text):
            color = self.COLORS.get(level, "#ddd")
            self.view.append(f'<span style="color:{color}">{text}</span>')

        def _save(self):
            path, _ = QFileDialog.getSaveFileName(self, "Save Log", "",
                                                  "Text files (*.txt)")
            if path:
                with open(path, "w") as f:
                    f.write(self.view.toPlainText())

    class ImageViewer(QScrollArea):
        """Zoom 10-400%, fit-to-view, draggable split divider, four view
        modes. All state math lives
        in gui/controller.py (compose_view / fit_zoom / drag_split_position)
        so it is tested headlessly; this class is the Qt shell."""

        def __init__(self):
            super().__init__()
            from neural_enhanced_super_resolution_torch.gui.controller import (
                compose_view, drag_split_position, fit_zoom)
            self._compose_view = compose_view
            self._fit_zoom = fit_zoom
            self._drag_split = drag_split_position
            self.label = QLabel()
            self.label.setAlignment(Qt.AlignCenter)
            self.setWidget(self.label)
            self.setWidgetResizable(True)
            self.zoom = 1.0
            self.fit = False
            self.mode = "side-by-side"
            self.split_pos = 0.5
            self.before: np.ndarray | None = None
            self.after: np.ndarray | None = None
            self.label.setMouseTracking(False)
            self.label.installEventFilter(self)

        def set_images(self, before=None, after=None):
            if before is not None:
                self.before = np.asarray(before)
            if after is not None:
                self.after = np.asarray(after)
            self._render()

        def set_zoom(self, percent: int):
            self.fit = False
            self.zoom = min(4.0, max(0.1, percent / 100.0))
            self._render()

        def fit_to_view(self):
            """Scale so the composed image fits the viewport."""
            self.fit = True
            self._render()

        def set_mode(self, mode: str):
            self.mode = mode
            self._render()

        def eventFilter(self, obj, event):
            # drag the split divider with the mouse (split mode only)
            from PyQt5.QtCore import QEvent
            if (obj is self.label and self.mode == "split"
                    and event.type() in (QEvent.MouseButtonPress,
                                         QEvent.MouseMove)
                    and getattr(event, "buttons", lambda: 0)() & Qt.LeftButton):
                pm = self.label.pixmap()
                if pm is not None and pm.width() > 1:
                    off = max(0, (self.label.width() - pm.width()) // 2)
                    self.split_pos = self._drag_split(
                        int(event.pos().x()) - off, pm.width())
                    self._render()
                    return True
            return super().eventFilter(obj, event)

        def resizeEvent(self, event):
            super().resizeEvent(event)
            if self.fit:
                self._render()

        def _render(self):
            img = self._compose_view(self.before, self.after, self.mode,
                                     self.split_pos)
            if img is None:
                return
            if self.fit:
                vp = self.viewport()
                self.zoom = self._fit_zoom(img.shape[:2],
                                           (vp.height(), vp.width()))
            pm = _np_to_pixmap(np.ascontiguousarray(img))
            if self.zoom != 1.0:
                pm = pm.scaled(int(pm.width() * self.zoom),
                               int(pm.height() * self.zoom),
                               Qt.KeepAspectRatio, Qt.SmoothTransformation)
            self.label.setPixmap(pm)

    class NESRApplication(QMainWindow):
        """The main window."""

        def __init__(self):
            super().__init__()
            self.setWindowTitle(
                "NESR — Neural Enhanced Super-Resolution (PyTorch)")
            self.resize(1200, 800)
            self.settings = EnhancementSettingsState()
            self.degradation = DegradationState()
            self.worker: EnhancementWorker | None = None
            self.input_path: str | None = None
            # Worker events cross the thread boundary via queued signals.
            self.bridge = _WorkerBridge()
            self.bridge.progress.connect(self._on_progress)
            self.bridge.image.connect(self._on_image)
            self.bridge.finished.connect(self._on_finished)
            self.bridge.error.connect(self._on_error)
            self.bridge.dl_progress.connect(
                lambda f: self.progress.setValue(int(f * 100)))
            self.bridge.dl_finished.connect(
                lambda r: QMessageBox.information(self, "NESR",
                                                  f"Downloads: {r}"))
            self._build_ui()
            self._check_models_on_start()

        # ----------------------------------------------------------- UI ---
        def _build_ui(self):
            open_act = QAction("Open", self)
            open_act.triggered.connect(self._open_image)
            enhance_act = QAction("Enhance", self)
            enhance_act.triggered.connect(self.start_enhancement)
            stop_act = QAction("Stop", self)
            stop_act.triggered.connect(self.stop_enhancement)
            download_act = QAction("Download Models", self)
            download_act.triggered.connect(self._download_models)
            tb = self.addToolBar("Main")
            for act in (open_act, enhance_act, stop_act, download_act):
                tb.addAction(act)

            self.viewer = ImageViewer()
            self.console = LogConsole()
            self.progress = QProgressBar()

            zoom = QSlider(Qt.Horizontal)
            zoom.setRange(10, 400)
            zoom.setValue(100)
            zoom.valueChanged.connect(self.viewer.set_zoom)
            fit_btn = QPushButton("Fit")
            fit_btn.clicked.connect(self.viewer.fit_to_view)
            mode = QComboBox()
            mode.addItems(["side-by-side", "split", "before", "after"])
            mode.currentTextChanged.connect(self.viewer.set_mode)

            tabs = QTabWidget()
            tabs.addTab(self._degradation_tab(), "Degradation")
            tabs.addTab(self._enhancement_tab(), "Enhancement")
            tabs.addTab(self._advanced_tab(), "Advanced")
            tabs.addTab(self.console, "Log")

            left = QVBoxLayout()
            ctl = QHBoxLayout()
            ctl.addWidget(QLabel("Zoom"))
            ctl.addWidget(zoom)
            ctl.addWidget(fit_btn)
            ctl.addWidget(QLabel("View"))
            ctl.addWidget(mode)
            left.addLayout(ctl)
            left.addWidget(self.viewer)
            left.addWidget(self.progress)

            root = QHBoxLayout()
            leftw = QWidget(); leftw.setLayout(left)
            root.addWidget(leftw, 3)
            root.addWidget(tabs, 2)
            central = QWidget(); central.setLayout(root)
            self.setCentralWidget(central)

        def _degradation_tab(self):
            w = QWidget()
            form = QFormLayout(w)
            self.d_down = QDoubleSpinBox(minimum=0.1, maximum=1.0,
                                         singleStep=0.05, value=0.5)
            self.d_noise_type = QComboBox()
            self.d_noise_type.addItems(["gaussian", "salt_pepper", "speckle",
                                        "poisson"])
            self.d_noise = QDoubleSpinBox(minimum=0.0, maximum=1.0,
                                          singleStep=0.01, value=0.05)
            self.d_blur = QSpinBox(minimum=0, maximum=15, value=0)
            self.d_jpeg = QSpinBox(minimum=1, maximum=100, value=90)
            form.addRow("Downscale", self.d_down)
            form.addRow("Noise type", self.d_noise_type)
            form.addRow("Noise amount", self.d_noise)
            form.addRow("Blur radius", self.d_blur)
            form.addRow("JPEG quality", self.d_jpeg)
            preview = QPushButton("Preview")
            apply_b = QPushButton("Apply")
            reset = QPushButton("Reset")
            preview.clicked.connect(self._preview_degradation)
            apply_b.clicked.connect(self._apply_degradation)
            reset.clicked.connect(self._reset_degradation)
            row = QHBoxLayout()
            for btn in (preview, apply_b, reset):
                row.addWidget(btn)
            form.addRow(row)
            return w

        def _enhancement_tab(self):
            w = QWidget()
            form = QFormLayout(w)
            self.e_preset = QComboBox()
            self.e_preset.addItems(list(PRESETS))
            self.e_preset.currentTextChanged.connect(self._apply_preset)
            self.e_iter = QSpinBox(minimum=1, maximum=10, value=3)
            self.e_esrgan = QCheckBox(checked=True)
            self.e_diffusion = QCheckBox(checked=True)
            self.e_segment = QCheckBox(checked=True)
            self.e_denoise = QDoubleSpinBox(minimum=0.0, maximum=1.0,
                                            singleStep=0.1, value=0.5)
            self.e_sharpen = QCheckBox(checked=True)
            self.e_prompt = QLineEdit()
            form.addRow("Preset", self.e_preset)
            form.addRow("Iterations", self.e_iter)
            form.addRow("Use ESRGAN", self.e_esrgan)
            form.addRow("Use Diffusion", self.e_diffusion)
            form.addRow("Segment enhance", self.e_segment)
            form.addRow("Denoise level", self.e_denoise)
            form.addRow("Adaptive sharpening", self.e_sharpen)
            form.addRow("Prompt", self.e_prompt)
            return w

        def _advanced_tab(self):
            w = QWidget()
            form = QFormLayout(w)
            self.a_device = QComboBox()
            self.a_device.addItems(["auto", "cuda", "cpu"])
            self.a_tile = QSpinBox(minimum=128, maximum=1024, value=512)
            self.a_tiling = QCheckBox(checked=True)
            self.a_3ch = QCheckBox(checked=False)
            self.a_outdir = QLineEdit("outputs")
            self.a_intermediate = QCheckBox(checked=False)
            form.addRow("Device", self.a_device)
            form.addRow("Max tile size", self.a_tile)
            form.addRow("Enable tiling", self.a_tiling)
            form.addRow("Force 3-channel", self.a_3ch)
            form.addRow("Output dir", self.a_outdir)
            form.addRow("Intermediate saves", self.a_intermediate)
            return w

        # ------------------------------------------------------- actions ---
        def _open_image(self):
            path, _ = QFileDialog.getOpenFileName(
                self, "Open Image", "",
                "Images (*.png *.jpg *.jpeg *.bmp *.tiff)")
            if not path:
                return
            from neural_enhanced_super_resolution_torch.utils.io import (
                imread_rgb)
            self.input_path = path
            img = imread_rgb(path)
            self.degradation.load(img)
            self.viewer.set_images(before=img)

        def _preview_degradation(self):
            if self.degradation.original is None:
                QMessageBox.warning(self, "NESR", "Open an image first")
                return
            img = self.degradation.preview(
                downscale=self.d_down.value(),
                noise_type=self.d_noise_type.currentText(),
                noise_amount=self.d_noise.value(),
                blur_radius=self.d_blur.value(),
                jpeg_quality=self.d_jpeg.value())
            self.viewer.set_images(after=img)

        def _apply_degradation(self):
            try:
                img = self.degradation.apply()
            except ValueError as exc:
                QMessageBox.warning(self, "NESR", str(exc))
                return
            from neural_enhanced_super_resolution_torch.utils.io import (
                imwrite_rgb)
            tmp = os.path.join(self.a_outdir.text(), "_degraded_input.png")
            imwrite_rgb(tmp, img)
            self.input_path = tmp
            self.viewer.set_images(before=img, after=None)

        def _reset_degradation(self):
            try:
                img = self.degradation.reset()
            except ValueError:
                return
            self.viewer.set_images(before=img, after=None)

        def _apply_preset(self, name):
            self.settings.apply_preset(name)
            self.e_iter.setValue(self.settings.iterations)
            self.e_esrgan.setChecked(self.settings.use_esrgan)
            self.e_diffusion.setChecked(self.settings.use_diffusion)
            self.e_segment.setChecked(self.settings.segment_enhancement)
            self.e_denoise.setValue(self.settings.denoise_level)
            self.e_sharpen.setChecked(self.settings.adaptive_sharpening)
            self.e_prompt.setText(self.settings.prompt)

        def _collect_settings(self):
            s = self.settings
            s.iterations = self.e_iter.value()
            s.use_esrgan = self.e_esrgan.isChecked()
            s.use_diffusion = self.e_diffusion.isChecked()
            s.segment_enhancement = self.e_segment.isChecked()
            s.denoise_level = self.e_denoise.value()
            s.adaptive_sharpening = self.e_sharpen.isChecked()
            s.prompt = self.e_prompt.text() or ""
            s.device = self.a_device.currentText()
            s.max_tile_size = self.a_tile.value()
            s.enable_tiling = self.a_tiling.isChecked()
            s.force_3channel = self.a_3ch.isChecked()
            s.output_dir = self.a_outdir.text()
            s.intermediate_saves = self.a_intermediate.isChecked()
            return s

        def start_enhancement(self):
            if not self.input_path:
                QMessageBox.warning(self, "NESR", "Open an image first")
                return
            s = self._collect_settings()
            from neural_enhanced_super_resolution_torch import (
                SuperResolutionPipeline)
            pipeline = SuperResolutionPipeline(device=s.device,
                                               config=s.to_config())
            self.worker = EnhancementWorker(
                pipeline, self.input_path, s.prompt or None,
                on_progress=lambda *a: self.bridge.progress.emit(*a),
                on_image=self.bridge.image.emit,
                on_finished=self.bridge.finished.emit,
                on_error=self.bridge.error.emit)
            self.progress.setRange(0, s.iterations)
            self.worker.start()

        def stop_enhancement(self):
            if self.worker:
                self.worker.stop()

        def _download_models(self):
            self.dl_worker = ModelDownloadWorker(
                on_progress=self.bridge.dl_progress.emit,
                on_finished=self.bridge.dl_finished.emit,
                on_error=self.bridge.error.emit)
            self.progress.setRange(0, 100)
            self.dl_worker.start()

        def _check_models_on_start(self):
            status = check_model_status()
            if status["missing_required"]:
                logger.warning("Missing required models: %s",
                               status["missing_required"])

        # ------------------------------------------------------- events ----
        def _on_progress(self, stage, iteration, total, message):
            self.progress.setValue(iteration)
            self.statusBar().showMessage(f"{stage}: {message}")

        def _on_image(self, img):
            self.viewer.set_images(after=img)

        def _on_finished(self, path):
            self.statusBar().showMessage(f"Saved: {path}")
            from neural_enhanced_super_resolution_torch.utils.io import (
                imread_rgb)
            self.viewer.set_images(after=imread_rgb(path))

        def _on_error(self, message):
            QMessageBox.critical(self, "NESR", message)

else:  # no Qt installed

    class NESRApplication:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            raise ImportError(
                "PyQt5 is not installed; use the CLI (python -m "
                "neural_enhanced_super_resolution_torch --cli) or install "
                "PyQt5")


def apply_theme(app) -> str:
    """The theme ladder: qtmodern dark if installed, else Qt's Fusion
    style, else the platform default. Returns the applied theme's name."""
    try:  # pragma: no cover - qtmodern not in the base image
        import qtmodern.styles
        qtmodern.styles.dark(app)
        return "qtmodern-dark"
    except Exception:
        pass
    try:
        from PyQt5.QtWidgets import QStyleFactory
        if "Fusion" in QStyleFactory.keys():
            app.setStyle("Fusion")
            return "fusion"
    except Exception:  # pragma: no cover
        pass
    return "default"


def run_gui() -> int:
    """Launch the Qt application."""
    if not HAS_QT:
        raise ImportError("PyQt5 is not installed")
    import sys  # pragma: no cover
    app = QApplication(sys.argv)  # pragma: no cover
    theme = apply_theme(app)  # pragma: no cover
    logging.getLogger("nesr.gui").info("GUI theme: %s", theme)  # pragma: no cover
    win = NESRApplication()  # pragma: no cover
    win.show()  # pragma: no cover
    return app.exec_()  # pragma: no cover
