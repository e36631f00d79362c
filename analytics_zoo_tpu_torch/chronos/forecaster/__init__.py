"""The forecasters, as JAX's package exports them: TCN, LSTM, Seq2Seq
and MTNet (torch modules on the port's Estimator), TCMF (a
factorization and two TCNs), and the classical ARIMA and Prophet (host
numpy and scipy).  Nothing here imports pandas: Prophet imports it
inside the functions that take or make a DataFrame."""

from analytics_zoo_tpu_torch.chronos.forecaster.lstm_forecaster import (  # noqa: F401,E501
    LSTMForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.tcn_forecaster import (  # noqa: F401,E501
    TCNForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.seq2seq_forecaster import (  # noqa: F401,E501
    Seq2SeqForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.arima_forecaster import (  # noqa: F401,E501
    ARIMAForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.prophet_forecaster import (  # noqa: F401,E501
    ProphetForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.mtnet_forecaster import (  # noqa: F401,E501
    MTNetForecaster,
)
from analytics_zoo_tpu_torch.chronos.forecaster.tcmf_forecaster import (  # noqa: F401,E501
    TCMFForecaster,
)
