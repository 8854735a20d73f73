"""Known-bad: blocking calls inside async handlers (blocking-in-async);
the offloaded nested def and asyncio.sleep are clean."""
import asyncio
import subprocess
import time


async def handler(request):
    time.sleep(1)                     # BAD: blocks the event loop
    subprocess.run(['true'], timeout=5)   # BAD: blocks the event loop

    def offloaded():
        time.sleep(1)                 # runs on an executor thread: clean
    await asyncio.get_running_loop().run_in_executor(None, offloaded)
    await asyncio.sleep(0)
