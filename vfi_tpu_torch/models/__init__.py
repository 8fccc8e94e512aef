"""Fill-in models of the port."""

from .fill_in import (BidirectionalSimpleAverageFillInModel, BidirectionalTimeWeightedAverageFillInModel,
                      MCNetFillInModel, TAIFillInModel, TimeWeightedPFFillInModel, TWIFillInModel)
from .legacy_sct import SCTSkipConFillInModel, SCTSuperSkipConFillInModel
from .registry import create_model, model_keys
from .sct import SCT_CLASSES, BaseSCTFillInModel
from .slomo import SloMoFillInModel

__all__ = ["BaseSCTFillInModel", "BidirectionalSimpleAverageFillInModel",
           "BidirectionalTimeWeightedAverageFillInModel", "MCNetFillInModel", "SCT_CLASSES",
           "SCTSkipConFillInModel", "SCTSuperSkipConFillInModel", "SloMoFillInModel", "TAIFillInModel",
           "TWIFillInModel", "TimeWeightedPFFillInModel", "create_model", "model_keys"]
