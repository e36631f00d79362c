from analytics_zoo_tpu_torch.chronos.data.tsdataset import TSDataset  # noqa: F401,E501
