"""Chronos time-series forecasting (counterpart of
analytics_zoo_tpu/chronos/): `data.TSDataset` and
`data.experimental.XShardsTSDataset`, the forecasters (`forecaster`:
TCN, LSTM, Seq2Seq, MTNet, TCMF, ARIMA, Prophet), AutoTS (`autots`,
its classical legs' `autots.model` and the deprecated
`autots.deprecated`), the anomaly detectors (`detector.anomaly`) and
the DoppelGANger simulator (`simulator`)."""
