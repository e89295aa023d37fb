"""The OS4M engine: statistics, host schedulers, wave planner, MapReduce job.

``scheduler``/``bss``/``pipeline``/``clustering``/``simulator``/
``slot_speeds`` are numpy copies of the reference's host planners and
cost model; ``stats``/``stats_provider`` collect the per-slot statistics
(exact ``K^(i)`` or count-min cells); ``mapreduce`` drives phase A, the
host plan and phase B; ``schedule_cache`` holds the plan phase B executes
(``CachedSchedule``) and the reuse policy and cache around it;
``multi_job`` runs N jobs on one mesh in a weighted-completion order.
"""
