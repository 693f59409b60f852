"""``paddle`` for configs parsed by the port: ``paddle.trainer_config_helpers``
and ``paddle.trainer.config_parser`` resolve to ``paddle_tpu_torch``, and so
does ``paddle.trainer.PyDataProvider2`` (the data providers' contract).
Put on ``sys.path`` by ``paddle_tpu_torch.compat.paddle_shim``."""
