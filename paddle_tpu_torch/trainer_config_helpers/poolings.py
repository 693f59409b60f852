"""Pooling type objects (API of the reference's poolings.py)."""

__all__ = ["BasePoolingType", "MaxPooling", "AvgPooling", "SumPooling", "SquareRootNPooling"]


class BasePoolingType:
    name = ""


class MaxPooling(BasePoolingType):
    name = "max"


class AvgPooling(BasePoolingType):
    name = "average"


class SumPooling(BasePoolingType):
    name = "sum"


class SquareRootNPooling(BasePoolingType):
    name = "squarerootn"
