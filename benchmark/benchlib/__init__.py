"""The benchmark's own library: finding cells, configurations, entries,
metric readers and work counts by name (`spec`), making the traffic from
the seed (`traffic`), timing the window (`window`), reading the device
trace and the spans (`trace`), and the peaks of the card (`peaks`)."""
