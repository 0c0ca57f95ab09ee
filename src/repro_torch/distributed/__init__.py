"""Distribution helpers of the port: scenario packing, admission
placement (``sharding``) and the lane pools' heartbeat monitor
(``fault_tolerance``)."""
