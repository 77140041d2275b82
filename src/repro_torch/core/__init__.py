"""Sampling and estimation: OASRS, Eq. 5-9 estimators, the interval ring."""
