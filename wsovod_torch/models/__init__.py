from .meta_arch import GeneralizedRCNN_WSOVOD, build_model

__all__ = ["GeneralizedRCNN_WSOVOD", "build_model"]
