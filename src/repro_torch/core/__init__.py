"""The OS4M engine: statistics, host schedulers, wave planner, MapReduce job.

``scheduler``/``bss``/``pipeline``/``clustering`` are numpy copies of the
reference's host planners; ``stats``/``stats_provider`` collect the
per-slot ``K^(i)``; ``mapreduce`` drives phase A, the host plan and
phase B; ``schedule_cache.CachedSchedule`` is the plan phase B executes.
"""
