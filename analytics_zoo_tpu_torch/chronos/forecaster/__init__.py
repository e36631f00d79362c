"""The forecasters ported so far: TCN, LSTM and Seq2Seq.  JAX's package
also exports ARIMA, Prophet, MTNet and TCMF, which come with the next
Chronos slice (ROADMAP Queue 1 item 5).  Nothing here imports pandas."""

from analytics_zoo_tpu_torch.chronos.forecaster.lstm_forecaster import (  # noqa: F401,E501
    LSTMForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.tcn_forecaster import (  # noqa: F401,E501
    TCNForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.seq2seq_forecaster import (  # noqa: F401,E501
    Seq2SeqForecaster,
)
