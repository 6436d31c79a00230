from .visualizer import SlamVisualizer
from .monitor import render_covariance_dashboard, watch

__all__ = ["SlamVisualizer", "render_covariance_dashboard", "watch"]
