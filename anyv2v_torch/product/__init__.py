"""The product layer (counterpart of ``anyv2v_tpu/product``): the in-process
AnyV2V runner, the Replicate-style predictor, the gradio and web demos.
PIL, OpenCV and gradio are imported by the file-level functions alone."""

from .anyv2v import AnyV2VRunner, perform_anyv2v
from .gradio_app import DEFAULTS, EDITOR_FOR_VARIANT, build_demo, run_headless
from .predictor import Predictor
from .web_demo import serve

__all__ = ["AnyV2VRunner", "perform_anyv2v", "Predictor", "DEFAULTS", "EDITOR_FOR_VARIANT",
           "run_headless", "build_demo", "serve"]
