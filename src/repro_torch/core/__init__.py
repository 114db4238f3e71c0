"""Engine core of the PyTorch port: graph, queues, comm, routing, program,
engine and the host drivers."""
