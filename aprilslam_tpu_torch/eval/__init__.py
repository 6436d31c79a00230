from .ate import ate_eval
from .metrics import (
    PoseErrorStats,
    pose_errors,
    percentage_error,
    align_umeyama,
    ate_rmse,
    trajectory_report,
)
from .logger import DataLogger, MAIN_HEADER, ERROR_HEADER, COV_HEADER
from .analysis import (
    error_analysis,
    covariance_report,
    pca,
    kmeans,
    linear_regression,
    standardize,
    ErrorAnalysisResult,
)

__all__ = [
    "ate_eval",
    "PoseErrorStats",
    "pose_errors",
    "percentage_error",
    "align_umeyama",
    "ate_rmse",
    "trajectory_report",
    "DataLogger",
    "MAIN_HEADER",
    "ERROR_HEADER",
    "COV_HEADER",
    "error_analysis",
    "covariance_report",
    "pca",
    "kmeans",
    "linear_regression",
    "standardize",
    "ErrorAnalysisResult",
]
