"""Distribution helpers of the port: scenario packing, admission
placement (``sharding``), the heartbeat monitor, elastic data assignment
and the training controller (``fault_tolerance``), and int8 gradient
compression (``collectives``)."""
