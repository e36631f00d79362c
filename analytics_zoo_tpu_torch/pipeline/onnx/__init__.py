from analytics_zoo_tpu_torch.pipeline.onnx.onnx_loader import (
    OnnxModule,
    load_onnx,
)

__all__ = ["load_onnx", "OnnxModule"]
