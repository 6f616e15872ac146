// Native Brainfuck trace recorder.
//
// The VM hot loop (ref vm.py:202-286) is O(T) scalar work — microseconds
// per step in python, which at 2^20+ cycles becomes a minute of trace
// generation before proving starts. This records the full algebraic
// execution trace (processor registers per cycle, instruction rows, I/O
// symbols) plus the derived memory matrix (sort by pointer + dummy-row
// clk-gap fill, ref memory_table.py:20-38) at native speed.
//
// The caller owns each trace: vm_create gives a handle, vm_simulate records
// into it, the row counts and vm_fill read it (count, then fill, so the
// python side owns all allocations) and vm_destroy frees it. Threads that
// simulate at once, each with its own handle, never share state. Input
// symbols arrive as u64 code points, as the python recorder reads them.
// Field semantics: cells and pointers live in F_p, p = 2^64 - 2^32 + 1;
// mv_inverse is the field inverse witness.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;

inline uint64_t addp(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += 0xFFFFFFFFULL;
  if (s >= P) s -= P;
  return s;
}

inline uint64_t subp(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= 0xFFFFFFFFULL;
  return d;
}

inline uint64_t mulp(uint64_t a, uint64_t b) {
  __uint128_t w = (__uint128_t)a * b;
  uint64_t lo = (uint64_t)w;
  uint64_t hi = (uint64_t)(w >> 64);
  uint64_t hh = hi >> 32, hl = hi & 0xFFFFFFFFULL;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= 0xFFFFFFFFULL;
  uint64_t t1 = hl * 0xFFFFFFFFULL;
  uint64_t r = t0 + t1;
  if (r < t1) r += 0xFFFFFFFFULL;
  if (r >= P) r -= P;
  return r;
}

inline uint64_t powp(uint64_t a, uint64_t e) {
  uint64_t acc = 1;
  while (e) {
    if (e & 1) acc = mulp(acc, a);
    a = mulp(a, a);
    e >>= 1;
  }
  return acc;
}

inline uint64_t invp(uint64_t a) { return a ? powp(a, P - 2) : 0; }

struct Trace {
  std::vector<uint64_t> processor;    // rows of 7
  std::vector<uint64_t> instruction;  // rows of 3 (sorted by addr)
  std::vector<uint64_t> input_rows;
  std::vector<uint64_t> output_rows;
  std::vector<uint64_t> memory;  // rows of 4
  int status = 0;                // 0 ok, <0 error
};

int simulate(Trace& t, const uint64_t* program, size_t n,
             const uint64_t* input, size_t input_len) {
  t = Trace();
  uint64_t ip = 0, mp = 0, mv = 0, mvi = 0, clk = 0;
  uint64_t ci = n > 0 ? program[0] : 0;
  uint64_t ni = n > 1 ? program[1] : 0;
  std::unordered_map<uint64_t, uint64_t> memory;
  size_t in_ptr = 0;

  t.instruction.reserve(3 * (n + 1024));
  for (size_t i = 0; i < n; i++) {
    t.instruction.push_back(i);
    t.instruction.push_back(program[i]);
    t.instruction.push_back(i + 1 < n ? program[i + 1] : 0);
  }

  while (ip < n) {
    t.processor.insert(t.processor.end(), {clk, ip, ci, ni, mp, mv, mvi});
    t.instruction.insert(t.instruction.end(), {ip, ci, ni});

    switch (ci) {  // the full code: only exact instruction codes dispatch
      case '[':
        ip = (mv == 0) ? program[ip + 1] : ip + 2;
        break;
      case ']':
        ip = (mv != 0) ? program[ip + 1] : ip + 2;
        break;
      case '<':
        ip += 1;
        mp = subp(mp, 1);
        break;
      case '>':
        ip += 1;
        mp = addp(mp, 1);
        break;
      case '+': {
        ip += 1;
        auto& cell = memory[mp];
        cell = addp(cell, 1);
        break;
      }
      case '-': {
        ip += 1;
        auto& cell = memory[mp];
        cell = subp(cell, 1);
        break;
      }
      case '.': {
        ip += 1;
        auto it = memory.find(mp);
        t.output_rows.push_back(it == memory.end() ? 0 : it->second);
        break;
      }
      case ',': {
        ip += 1;
        if (in_ptr >= input_len) {
          t.status = -1;  // input exhausted
          return -1;
        }
        memory[mp] = input[in_ptr++];
        t.input_rows.push_back(memory[mp]);
        break;
      }
      default:
        t.status = -2;  // unrecognized instruction
        return -2;
    }

    clk += 1;
    ci = ip < n ? program[ip] : 0;
    ni = ip + 1 < n ? program[ip + 1] : 0;
    auto it = memory.find(mp);
    mv = it == memory.end() ? 0 : it->second;
    mvi = invp(mv);
  }
  t.processor.insert(t.processor.end(), {clk, ip, ci, ni, mp, mv, mvi});
  t.instruction.insert(t.instruction.end(), {ip, ci, ni});

  // sort instruction rows by address (stable — preserves clk order within
  // an address, matching python's stable list.sort, ref vm.py:302)
  size_t rows = t.instruction.size() / 3;
  std::vector<uint32_t> order(rows);
  for (size_t i = 0; i < rows; i++) order[i] = (uint32_t)i;
  std::stable_sort(order.begin(), order.end(),
                   [&](uint32_t x, uint32_t y) {
                     return t.instruction[3 * x] < t.instruction[3 * y];
                   });
  std::vector<uint64_t> sorted;
  sorted.reserve(t.instruction.size());
  for (uint32_t i : order)
    sorted.insert(sorted.end(), t.instruction.begin() + 3 * i,
                  t.instruction.begin() + 3 * i + 3);
  t.instruction = std::move(sorted);

  // derive memory matrix: non-padding processor rows sorted by (mp, clk),
  // dummy rows filling clk gaps (ref memory_table.py:20-38)
  size_t prows = t.processor.size() / 7;
  std::vector<uint32_t> sel;
  sel.reserve(prows);
  for (size_t i = 0; i < prows; i++)
    if (t.processor[7 * i + 2] != 0) sel.push_back((uint32_t)i);
  std::stable_sort(sel.begin(), sel.end(), [&](uint32_t x, uint32_t y) {
    return t.processor[7 * x + 4] < t.processor[7 * y + 4];
  });
  for (uint32_t i : sel) {
    uint64_t rclk = t.processor[7 * i + 0];
    uint64_t rmp = t.processor[7 * i + 4];
    uint64_t rmv = t.processor[7 * i + 5];
    size_t m = t.memory.size() / 4;
    if (m > 0 && t.memory[4 * (m - 1) + 1] == rmp) {
      uint64_t prev_clk = t.memory[4 * (m - 1) + 0];
      uint64_t prev_mv = t.memory[4 * (m - 1) + 2];
      uint64_t gap_clk = addp(prev_clk, 1);
      while (gap_clk != rclk) {
        t.memory.insert(t.memory.end(), {gap_clk, rmp, prev_mv, 1});
        gap_clk = addp(gap_clk, 1);
      }
    }
    t.memory.insert(t.memory.end(), {rclk, rmp, rmv, 0});
  }
  return 0;
}

}  // namespace

extern "C" {

void* vm_create() { return new Trace(); }

void vm_destroy(void* h) { delete static_cast<Trace*>(h); }

// Runs the simulation into the handle's trace; returns 0 on success, -1
// when the input is exhausted, -2 on an unrecognized instruction. Sizes
// are then queried and buffers filled.
int vm_simulate(void* h, const uint64_t* program, size_t n,
                const uint64_t* input, size_t input_len) {
  return simulate(*static_cast<Trace*>(h), program, n, input, input_len);
}

size_t vm_processor_rows(void* h) {
  return static_cast<Trace*>(h)->processor.size() / 7;
}
size_t vm_instruction_rows(void* h) {
  return static_cast<Trace*>(h)->instruction.size() / 3;
}
size_t vm_memory_rows(void* h) {
  return static_cast<Trace*>(h)->memory.size() / 4;
}
size_t vm_input_rows(void* h) {
  return static_cast<Trace*>(h)->input_rows.size();
}
size_t vm_output_rows(void* h) {
  return static_cast<Trace*>(h)->output_rows.size();
}

void vm_fill(void* h, uint64_t* processor, uint64_t* instruction,
             uint64_t* memory, uint64_t* input_rows, uint64_t* output_rows) {
  const Trace& t = *static_cast<Trace*>(h);
  std::memcpy(processor, t.processor.data(), t.processor.size() * 8);
  std::memcpy(instruction, t.instruction.data(), t.instruction.size() * 8);
  std::memcpy(memory, t.memory.data(), t.memory.size() * 8);
  std::memcpy(input_rows, t.input_rows.data(), t.input_rows.size() * 8);
  std::memcpy(output_rows, t.output_rows.data(), t.output_rows.size() * 8);
}
}
