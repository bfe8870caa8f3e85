"""The entries of the program that traffic mixes drive, one module each,
found by the traffic's ``entry``. A module has:

* ``pool(cfg, traffic, seed, device)``: the list of the calls' inputs,
  made from the seed in set-up (a call takes them in turn);
* ``Program(cfg, device, seed)``, the timed path: ``prepare(item)`` once
  an item in set-up, ``call(inputs, keep=False)`` returning (the call's
  answer on the host, the outputs the check compares where ``keep``, else
  None), ``close()``, and ``spans``, ``counters`` and ``time_spans`` for
  the per-layer metrics;
* ``missed(item, answer, check)``: whether the call counts as failed;
* ``shapes(cfg, items)``: what the per-layer metrics count work from;
* ``reference(item, cfg, prec, seed)`` and ``numbers(kept, ref)``: the
  plain reference's outputs and the numbers compared, each 0 where the
  two agree.
"""
