"""Chronos time-series forecasting (counterpart of
analytics_zoo_tpu/chronos/): `data.TSDataset`, the TCN, LSTM and
Seq2Seq forecasters (`forecaster`) and AutoTS (`autots`)."""
