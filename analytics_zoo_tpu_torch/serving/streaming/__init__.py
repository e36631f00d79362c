"""The streaming data plane (a port of analytics_zoo_tpu/serving/
streaming/): the durable, replayable ingestion path that Cluster
Serving had in Redis streams and Flink consumer groups.

* `StreamLog` (log.py): CRC32C-framed append-only segments with fsync
  batching, rotation, retention and torn-tail recovery;
* `DurableStream` / `StreamHub` (stream.py): consumer groups with
  visibility-deadline leases, durable ack cursors, dead-consumer replay
  and the `StreamBacklogFull` bound;
* consumers (consumer.py): the worker pool's batch predict and the
  generation engine draining a stream as a group;
* open_loop.py: the seeded Poisson / bursty arrival harness.
"""

from analytics_zoo_tpu_torch.serving.streaming.consumer import (
    StreamConsumer,
    generation_consumer,
    predict_consumer,
)
from analytics_zoo_tpu_torch.serving.streaming.log import StreamLog
from analytics_zoo_tpu_torch.serving.streaming.open_loop import (
    bursty_trace,
    poisson_trace,
    run_open_loop,
)
from analytics_zoo_tpu_torch.serving.streaming.stream import (
    DurableStream,
    StreamBacklogFull,
    StreamHub,
    StreamRecord,
)

__all__ = ["StreamLog", "DurableStream", "StreamHub", "StreamRecord",
           "StreamBacklogFull", "StreamConsumer", "predict_consumer",
           "generation_consumer", "poisson_trace", "bursty_trace",
           "run_open_loop"]
