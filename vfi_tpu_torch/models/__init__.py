"""Fill-in models of the port."""

from .fill_in import (BidirectionalSimpleAverageFillInModel, BidirectionalTimeWeightedAverageFillInModel,
                      MCNetFillInModel, TAIFillInModel, TimeWeightedPFFillInModel, TWIFillInModel)
from .registry import create_model, model_keys

__all__ = ["BidirectionalSimpleAverageFillInModel", "BidirectionalTimeWeightedAverageFillInModel",
           "MCNetFillInModel", "TAIFillInModel", "TWIFillInModel", "TimeWeightedPFFillInModel", "create_model",
           "model_keys"]
